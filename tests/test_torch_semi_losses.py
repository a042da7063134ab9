"""The semi-supervised path's losses, schedule, EMA and heads: spcl_torch
against spcl_tpu on seeded numpy inputs, values and gradients, on the CPU.

spcl_tpu's dense inputs are NHWC and its class axis last; the port's are
NCHW with the class axis second, so every input goes to the port
transposed and every dense output comes back transposed. Gradients are
those of sum(out * r) for a fixed random r, with respect to every input.

Tolerance: float32 reductions in another order — rtol 1e-5, atol 1e-6 on
values and gradients of the losses; the heads and the MINE net 1e-5 / 1e-5
(a convolution or matmul summed in another order); GroupNorm's variance is
one-pass E[x^2] - mean^2 in flax and two-pass in torch: 1e-4 there. The
EMA update is checked to the bit (the same float32 operations in the same
order), the schedule's floats to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.hooks import mine as jmine
from spcl_tpu.losses import functional as jfun
from spcl_tpu.losses import iic as jiic
from spcl_tpu.losses import kl as jkl
from spcl_tpu.losses import pica as jpica
from spcl_tpu.models.heads import ClusterHead as JaxClusterHead
from spcl_tpu.models.heads import DenseClusterHead as JaxDenseClusterHead
from spcl_tpu.schedulers.gamma import RampScheduler as JaxRamp
from spcl_tpu.training.state import TrainState
from spcl_tpu.training.steps import _ema_after_step
from spcl_torch.hooks.mine import MineStatNet
from spcl_torch.losses import functional as fun
from spcl_torch.losses import iic, kl, pica
from spcl_torch.models import (ClusterHead, DenseClusterHead, ema_update,
                               head_state_dict_from_flax, semi_step_alpha)
from spcl_torch.schedulers import RampScheduler

TOL = dict(rtol=1e-5, atol=1e-6)
HEAD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its CPU ops are small, and the
    suite runs test files side by side in several processes, where spinning
    intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _probs(rng, shape, axis):
    x = rng.normal(size=shape).astype(np.float32) * 2
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _nchw(x):
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


def _compare(jfn, tfn, jax_inputs, torch_inputs, out_to_torch=lambda x: x, tol=TOL):
    """Value of jfn(*jax_inputs) against tfn(*torch_inputs) and the
    gradients of sum(out * r) with respect to every input; `out_to_torch`
    maps a JAX output (numpy) into the port's layout. Torch inputs are
    transposed views of the JAX ones, so the gradients are compared after
    the same transposition: `torch_inputs` holds (array, to_torch) pairs."""
    jout = np.asarray(jax.jit(jfn)(*[jnp.asarray(x) for x in jax_inputs]))
    tin = [torch.tensor(conv(x), requires_grad=True) for x, conv in torch_inputs]
    tout = tfn(*tin)
    np.testing.assert_allclose(tout.detach().numpy(), out_to_torch(jout), **tol)
    r = np.random.default_rng(99).normal(size=jout.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda *xs: jnp.sum(jfn(*xs) * r),
                              argnums=tuple(range(len(jax_inputs)))))(
        *[jnp.asarray(x) for x in jax_inputs])
    (tout * torch.from_numpy(out_to_torch(r))).sum().backward()
    for t, g, (_, conv) in zip(tin, jgrads, torch_inputs):
        np.testing.assert_allclose(t.grad.numpy(), conv(np.asarray(g)), **tol)


def _ident(x):
    return np.ascontiguousarray(x)


# ------------------------------------------------------------------ functional
def test_functional_helpers_match():
    rng = np.random.default_rng(0)
    p = _probs(rng, (3, 6, 5, 4), -1)
    assert fun.simplex(torch.from_numpy(_nchw(p))) == jfun.simplex(jnp.asarray(p))
    bad = p * 1.1
    assert fun.simplex(torch.from_numpy(_nchw(bad))) == jfun.simplex(jnp.asarray(bad)) is False
    oh = np.asarray(jfun.probs2one_hot(jnp.asarray(p)))
    got = fun.probs2one_hot(torch.from_numpy(_nchw(p)))
    np.testing.assert_array_equal(got.numpy(), _nchw(oh))
    assert fun.one_hot_check(got) and jfun.one_hot_check(jnp.asarray(oh))
    assert not fun.one_hot_check(torch.from_numpy(_nchw(p)))
    flat = _probs(rng, (7, 5), -1)
    np.testing.assert_array_equal(fun.probs2one_hot(torch.from_numpy(flat), axis=1).numpy(),
                                  np.asarray(jfun.probs2one_hot(jnp.asarray(flat))))


# ------------------------------------------------------------------ kl
@pytest.mark.parametrize("name", ["kl_div", "entropy_loss", "cross_entropy_onehot"])
def test_kl_losses_match(name):
    rng = np.random.default_rng(1)
    pred = _probs(rng, (3, 8, 8, 4), -1)
    target = _probs(rng, (3, 8, 8, 4), -1)
    jfn, tfn = getattr(jkl, name), getattr(kl, name)
    if name == "entropy_loss":
        _compare(jfn, tfn, [pred], [(pred, _nchw)])
    elif name == "kl_div":
        _compare(jfn, tfn, [pred, target], [(pred, _nchw), (target, _nchw)])
    else:
        logits = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
        _compare(jfn, tfn, [logits, target], [(logits, _nchw), (target, _nchw)])


# ------------------------------------------------------------------ iic
def test_compute_joint_and_iid_loss_match():
    rng = np.random.default_rng(2)
    a, b = _probs(rng, (12, 6), -1), _probs(rng, (12, 6), -1)
    _compare(jiic.compute_joint, iic.compute_joint, [a, b], [(a, _ident), (b, _ident)])
    for k in (0, 1):
        _compare(lambda x, y: jiic.iid_loss(x, y, lamb=1.5)[k],
                 lambda x, y: iic.iid_loss(x, y, lamb=1.5)[k], [a, b], [(a, _ident), (b, _ident)])


@pytest.mark.parametrize("padding", [0, 2])
def test_iid_segmentation_loss_matches(padding):
    rng = np.random.default_rng(3 + padding)
    a, b = _probs(rng, (2, 10, 12, 5), -1), _probs(rng, (2, 10, 12, 5), -1)
    _compare(lambda x, y: jiic.iid_segmentation_loss(x, y, padding=padding),
             lambda x, y: iic.iid_segmentation_loss(x, y, padding=padding),
             [a, b], [(a, _nchw), (b, _nchw)])


def test_iid_segmentation_loss_with_mask_matches():
    rng = np.random.default_rng(5)
    a, b = _probs(rng, (2, 8, 8, 3), -1), _probs(rng, (2, 8, 8, 3), -1)
    mask = (rng.uniform(size=(2, 8, 8, 1)) > 0.3).astype(np.float32)
    jout = jiic.iid_segmentation_loss(jnp.asarray(a), jnp.asarray(b), padding=1,
                                      mask=jnp.asarray(mask))
    tout = iic.iid_segmentation_loss(torch.from_numpy(_nchw(a)), torch.from_numpy(_nchw(b)),
                                     padding=1, mask=torch.from_numpy(_nchw(mask)))
    np.testing.assert_allclose(float(tout), float(jout), **TOL)


@pytest.mark.parametrize("hw,patch,padding", [((20, 20), 8, 2), ((16, 24), 32, 3)])
def test_small_patch_loss_matches(hw, patch, padding):
    rng = np.random.default_rng(6)
    a, b = _probs(rng, (2,) + hw + (4,), -1), _probs(rng, (2,) + hw + (4,), -1)
    _compare(lambda x, y: jiic.iid_segmentation_small_patch_loss(x, y, padding=padding,
                                                                 patch_size=patch),
             lambda x, y: iic.iid_segmentation_small_patch_loss(x, y, padding=padding,
                                                                patch_size=patch),
             [a, b], [(a, _nchw), (b, _nchw)])


# ------------------------------------------------------------------ pica
def test_pui_losses_match():
    rng = np.random.default_rng(7)
    a, b = _probs(rng, (16, 5), -1), _probs(rng, (16, 5), -1)
    _compare(jpica.pui_loss, pica.pui_loss, [a, b], [(a, _ident), (b, _ident)])
    a, b = _probs(rng, (2, 6, 6, 5), -1), _probs(rng, (2, 6, 6, 5), -1)
    _compare(jpica.pui_seg_loss, pica.pui_seg_loss, [a, b], [(a, _nchw), (b, _nchw)])


# ------------------------------------------------------------------ schedule
@pytest.mark.parametrize("args", [(0, 10, 0.2, 0.9), (3, 8, 0.75, 0.75), (2, 2, 1.0, 0.1)])
def test_ramp_scheduler_matches(args):
    mine, theirs = RampScheduler(*args), JaxRamp(*args)
    for epoch in range(-1, 14):
        assert abs(mine.get_value(epoch) - theirs.get_value(epoch)) <= 1e-12
    for _ in range(4):
        mine.step()
        theirs.step()
    assert mine.value == theirs.value and mine.state_dict() == theirs.state_dict()
    fresh = RampScheduler(*args)
    fresh.load_state_dict(mine.state_dict())
    assert fresh.epoch == 4


# ------------------------------------------------------------------ EMA
@pytest.mark.parametrize("step,alpha_max", [(0, 0.999), (1, 0.999), (7, 0.9), (5000, 0.999)])
def test_ema_update_matches_the_semi_step(step, alpha_max):
    rng = np.random.default_rng(8 + step)
    t = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    s = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    state = TrainState(step=jnp.asarray(step, jnp.int32), params=None, batch_stats=None,
                       opt_state=None, teacher_params=jax.tree_util.tree_map(jnp.asarray, t))
    want = _ema_after_step(state, {"model": jax.tree_util.tree_map(jnp.asarray, s)}, alpha_max)
    teacher = [torch.from_numpy(t["a"].copy()), torch.from_numpy(t["b"].copy())]
    alpha = semi_step_alpha(step, alpha_max)
    ema_update(teacher, [torch.from_numpy(s["a"]), torch.from_numpy(s["b"])], alpha)
    np.testing.assert_array_equal(teacher[0].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(teacher[1].numpy(), np.asarray(want["b"]))
    if step == 0:
        assert alpha == 0.5  # the first update is the mean of teacher and student


# ------------------------------------------------------------------ heads
def _flax_head(module, xs, seed):
    variables = module.init(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in xs])
    # random biases too, so that the transplant is held on every tensor
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(np.float32)),
        variables["params"])
    return {"params": params}


@pytest.mark.parametrize("head_type", ["linear", "mlp"])
def test_cluster_head_matches(head_type):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 5, 5, 32)).astype(np.float32)
    jhead = JaxClusterHead(num_clusters=7, num_subheads=3, head_type=head_type,
                           temperature=0.5)
    variables = _flax_head(jhead, [x], 1)
    head = ClusterHead(32, num_clusters=7, num_subheads=3, head_type=head_type,
                       temperature=0.5)
    head.load_state_dict({k: torch.from_numpy(v)
                          for k, v in head_state_dict_from_flax(variables).items()}, strict=True)
    _compare(lambda f: jhead.apply(variables, f), head, [x], [(x, _nchw)], tol=HEAD_TOL)


@pytest.mark.parametrize("head_type", ["linear", "mlp"])
def test_dense_cluster_head_matches(head_type):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 6, 6, 16)).astype(np.float32)
    jhead = JaxDenseClusterHead(num_clusters=5, num_subheads=2, head_type=head_type,
                                hidden_dim=12)
    variables = _flax_head(jhead, [x], 2)
    head = DenseClusterHead(16, num_clusters=5, num_subheads=2, head_type=head_type,
                            hidden_dim=12)
    head.load_state_dict({k: torch.from_numpy(v)
                          for k, v in head_state_dict_from_flax(variables).items()}, strict=True)
    # [S, B, H, W, K] -> [S, B, K, H, W]
    _compare(lambda f: jhead.apply(variables, f), head, [x], [(x, _nchw)],
             out_to_torch=lambda y: np.ascontiguousarray(np.moveaxis(y, -1, 2)), tol=HEAD_TOL)


def test_mine_statistics_net_matches():
    rng = np.random.default_rng(11)
    f1 = rng.normal(size=(4, 6, 6, 64)).astype(np.float32)
    f2 = rng.normal(size=(4, 6, 6, 64)).astype(np.float32)
    jnet = jmine._MineStatNet(hidden=64)
    variables = _flax_head(jnet, [f1, f2], 3)
    jfn = lambda a, b: jnet.apply(variables, a, b)  # noqa: E731
    net = MineStatNet(128, 64)
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in head_state_dict_from_flax(variables).items()}, strict=True)
    _compare(jfn, net, [f1, f2], [(f1, _nchw), (f2, _nchw)], tol=dict(rtol=1e-4, atol=1e-4))
