"""Adaptive pooling, l2_normalize and the projection heads' `pool_name` in
spcl_torch against spcl_tpu, on the CPU.

- `adaptive_avg_pool` / `adaptive_max_pool` at output sizes 1x1, 2x2, 3x5 and
  10x10 (disjoint and overlapping bins): forward within 1e-6, and the input
  gradient of a random cotangent within 1e-6 of `jax.vjp` on inputs with
  exact ties (ReLU'd zeros, values on a coarse grid). `torch.amax` shares a
  tied bin's cotangent evenly, as JAX does; `F.adaptive_max_pool2d` routes it
  to one index, which a case here shows fails the same comparison.
- `ProjectionHead` / `DenseProjectionHead` with `pool_name="adaptive_max"`,
  weights carried over by `models/transplant.py`: outputs within 1e-5 and the
  input gradient within 1e-5.
- `DenseProjectionHead()` with its defaults has spcl_tpu's default shapes
  (hidden_dim 128, ROADMAP C16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spcl_tpu.models import heads as jheads
from spcl_torch.models import heads as theads
from spcl_torch.models.transplant import head_state_dict_from_flax
from torch_port_helpers import nchw

SIZES = [(1, 1), (2, 2), (3, 5), (10, 10)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def _tied(shape, seed):
    """NCHW values on a grid of 0.5 after a ReLU: zero windows and repeated maxima."""
    x = np.random.default_rng(seed).normal(size=shape)
    return np.maximum(np.round(x * 2) / 2, 0).astype(np.float32)


def _jax_pool_vjp(pool, x, size, ct):
    out, vjp = jax.vjp(jax.jit(lambda v: pool(v, size)), jnp.asarray(nhwc(x)))
    return nchw(np.asarray(out)), nchw(np.asarray(jax.jit(vjp)(jnp.asarray(nhwc(ct)))[0]))


def _torch_pool_vjp(pool, x, size, ct):
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    out = pool(xt, size)
    out.backward(torch.from_numpy(ct.copy()))
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("shape", [(2, 3, 20, 20), (2, 3, 14, 23)], ids=["20x20", "14x23"])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pool_and_its_gradient_match_spcl_tpu(kind, shape, size):
    jpool = {"avg": jheads.adaptive_avg_pool, "max": jheads.adaptive_max_pool}[kind]
    tpool = {"avg": theads.adaptive_avg_pool, "max": theads.adaptive_max_pool}[kind]
    x = _tied(shape, sum(shape) + size[0])
    if kind == "max":
        assert (x == 0).mean() > 0.4  # ties are everywhere
    ct = np.random.default_rng(7).normal(size=shape[:2] + size).astype(np.float32)
    want, want_dx = _jax_pool_vjp(jpool, x, size, ct)
    got, got_dx = _torch_pool_vjp(tpool, x, size, ct)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_dx, want_dx, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(1, 1), (2, 2), (3, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_torch_adaptive_max_pool2d_breaks_the_tie_rule(size):
    """The library pool routes a tied bin's cotangent to one index: at the
    same inputs its gradient is not JAX's, while its forward is."""
    x = _tied((2, 3, 20, 20), 3)
    ct = np.random.default_rng(7).normal(size=(2, 3) + size).astype(np.float32)
    want, want_dx = _jax_pool_vjp(jheads.adaptive_max_pool, x, size, ct)
    got, got_dx = _torch_pool_vjp(F.adaptive_max_pool2d, x, size, ct)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got_dx - want_dx).max() > 0.1


def test_the_tie_rule_on_one_window():
    x = torch.tensor([[[[1.0, 3.0], [3.0, 0.0]]]], requires_grad=True)
    theads.adaptive_max_pool(x, (1, 1)).sum().backward()
    assert x.grad.flatten().tolist() == [0.0, 0.5, 0.5, 0.0]


def test_l2_normalize_matches_spcl_tpu():
    x = np.random.default_rng(0).normal(size=(4, 6, 3)).astype(np.float32)
    x[1] = 0.0  # the eps floor
    for dim in (-1, 1):
        want = np.asarray(jheads.l2_normalize(jnp.asarray(x), axis=dim))
        got = theads.l2_normalize(torch.from_numpy(x), dim=dim).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _heads(dense, pool_name, spatial, c_in, seed):
    kw = dict(output_dim=32, hidden_dim=24, head_type="mlp", normalize=True,
              pool_name=pool_name, spatial_size=spatial)
    jhead = (jheads.DenseProjectionHead if dense else jheads.ProjectionHead)(**kw)
    size = 23 if dense else 14
    x = _tied((3, c_in, size, size), seed)
    x[:, :, :8, :8] = 0.0  # a window of zeros: tied values after the dense MLP too
    variables = jhead.init(jax.random.PRNGKey(seed), jnp.asarray(nhwc(x)))
    # non-zero biases, as in a trained head: flax starts them at zero, and a
    # zero window would then pool to a zero vector, where l2_normalize's
    # gradient is NaN in spcl_tpu and ct / eps in torch
    rng = np.random.default_rng(seed)
    variables = {"params": {name: {"kernel": np.asarray(layer["kernel"]),
                                   "bias": rng.normal(0.0, 0.1, layer["bias"].shape)
                                   .astype(np.float32)}
                            for name, layer in variables["params"].items()}}
    thead = (theads.DenseProjectionHead if dense else theads.ProjectionHead)(c_in, **kw)
    thead.load_state_dict({k: torch.from_numpy(v) for k, v in
                           head_state_dict_from_flax(variables).items()}, strict=True)
    return jhead, variables, thead, x


@pytest.mark.parametrize("dense,spatial", [(False, (1, 1)), (False, (2, 2)),
                                           (True, (10, 10)), (True, (5, 5))])
def test_heads_pooling_by_max_match_spcl_tpu(dense, spatial):
    jhead, variables, thead, x = _heads(dense, "adaptive_max", spatial, 8, spatial[0])
    out, vjp = jax.vjp(jax.jit(lambda v: jhead.apply(variables, v)), jnp.asarray(nhwc(x)))
    want = np.asarray(out)
    ct = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    want_dx = nchw(np.asarray(jax.jit(vjp)(jnp.asarray(ct))[0]))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    got = thead(xt)
    if dense:  # the port returns NCHW
        want, ct = nchw(want), nchw(ct)
    got.backward(torch.from_numpy(ct.copy()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0, atol=1e-5)


@pytest.mark.parametrize("head", ["ProjectionHead", "DenseProjectionHead"])
def test_pool_name_is_checked(head):
    with pytest.raises(ValueError):
        getattr(theads, head)(8, pool_name="adaptive_min")


def test_default_dense_head_has_spcl_tpu_shapes():
    """ROADMAP C16: a DenseProjectionHead built with its defaults."""
    c_in = 16
    variables = jheads.DenseProjectionHead().init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 12, 12, c_in)))
    want = {k: v.shape for k, v in head_state_dict_from_flax(variables).items()}
    head = theads.DenseProjectionHead(c_in)
    assert head.conv0.out_channels == 128
    assert {k: tuple(v.shape) for k, v in head.state_dict().items()} == want
    head.load_state_dict({k: torch.from_numpy(v) for k, v in
                          head_state_dict_from_flax(variables).items()}, strict=True)
