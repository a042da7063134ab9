"""Decoder pretraining (`main_pretrain_decoder.py`) in spcl_torch against
spcl_tpu, on the CPU.

- `DenseProjectionHead`: the 1x1-conv MLP at full resolution, then the
  adaptive pool, then the channel L2 normalisation, from transplanted
  weights, at a 112 -> 10 pool and at an odd one (13 -> 10); and the pool
  alone against spcl_tpu's `adaptive_avg_pool` (torch's bin edges). Outputs
  atol 1e-5 (float32 1x1 convolutions summed in another order).
- The dense InfoNCE and self-paced (soft) dense InfoNCE losses of a
  decoder-stage hook (Up_conv3, `contrast_on: self`, 10x10 grid, 5 points an
  image, a padded slice), with the points replayed from spcl_tpu's
  `fold_in(key, 17)` draws (`torch_port_helpers.jax_dense_draws`), through
  the fused criterion's plain version and through the dense losses: loss
  and sp_weight rtol 1e-4; the gradients of the head's parameters and of the
  decoder features relative L2 2e-4, the bound
  tests/test_torch_port_pretrain.py states for the head.
- Three `pretrain_decoder` steps under `nhwc` (UNet max_channel 128, the
  least spcl_tpu's UNet takes, crop 32 of a 40 canvas, 2 scans x 3
  partitions, RAdam at lr 1e-3 with weight decay 1e-2) in lockstep with spcl_tpu's `build_pretrain_step` (total_freedom
  false, the stage mask Conv5..Up_conv3), and one step under `pallas` at
  UNet-256 (the width at which the fused stages are packable), crop 32:
  - spcl_tpu's frozen Conv1 moves: its optimizer chain adds weight_decay x p
    to the masked (zero) gradients (spcl_tpu training/optim.py:39-40), so a
    frozen stage is not frozen (ROADMAP C8);
  - the port's frozen stages (Conv1-Conv4 and the stages past Up_conv3)
    stay bit-equal: they take no gradient and the optimizer never sees them;
  - the losses (rtol 1e-4) and the running statistics of every stage the
    forward ran, frozen ones included (rtol 1e-3, atol 1e-4, as
    tests/test_torch_finetune.py), agree;
  - the updates of the trainable leaves agree, relative L2. After the first
    step, where RAdam's update is lr x (gradient + weight_decay x p) and its
    relative error is the gradient's: the head and Up_conv3, next to the
    loss, to 2e-4 (tests/test_torch_port_pretrain.py's bound for the head
    and the tapped stage), or to 1.5x what the same stage moves in spcl_tpu
    itself under 1e-6 of input noise where that is more, never past 5e-4;
    Conv5..Up3 to 2e-2 (that file's bound for the noise-sensitive stages),
    or to 1.5x that stage's noise move, never past 5e-2. After the last
    step every leaf is held to the second bound: the deep stages' first-step
    differences reach the near-loss leaves in the later steps.
    Measured on the CPU at the test's seeds: spcl_tpu's own first-step moves
    under the noise are, nhwc / pallas, Conv5..Up4 0.98-1.39e-2 /
    1.22-2.67e-2, Up3 9.8e-3 / 5.7e-3, Up_conv3 3.0e-4 / 1.4e-3, head
    2.7e-4 / 1.5e-3 (`test_spcl_tpu_decoder_updates_move_under_input_noise`
    checks the order); the port's first-step errors are nhwc: head 2.3e-4,
    Up_conv3 2.6e-4, the rest <= 1.7e-2; pallas: head and Up_conv3
    <= 8.4e-5, Up3 2.0e-4, the rest <= 2.5e-2; after nhwc's third step
    <= 1.7e-2 (Up_conv3 and head <= 7e-3). Five points an image reach the
    decoder through train-mode BatchNorm at 2x2 (Conv5) and ReLU, which is
    why the deep stages move so much;
  - under `pallas` the fused stages run forward only: their inputs and
    weights need no gradient.
- The `spcl_torch.main_pretrain_decoder` entry at a tiny config, both phases.
- `chip_smoke.py`'s transcriptions of pretrain.yaml, hooks/infonce_dense.yaml
  and hooks/spinfonce.yaml (slice F runs without pyyaml) equal the files, and
  their merge is what ConfigManager merges.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import packing as jpacking
from spcl_tpu.data.creator import create_contrastive_loader as jax_contrastive_loader
from spcl_tpu.hooks.infonce import INFONCEHook as JaxHook
from spcl_tpu.hooks.infonce import SelfPacedINFONCEHook as JaxSPHook
from spcl_tpu.models.heads import DenseProjectionHead as JaxDenseHead
from spcl_tpu.models.heads import adaptive_avg_pool as jax_adaptive_avg_pool
from spcl_tpu.models.masking import stage_trainable_mask
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_tpu.training.steps import build_pretrain_step as jax_build_pretrain_step
from spcl_torch.data import augment as aug
from spcl_torch.data.creator import create_contrastive_loader
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.hooks import INFONCEHook, SelfPacedINFONCEHook
from spcl_torch.models import (DenseProjectionHead, UNet, head_state_dict_from_flax,
                               set_trainable_stages, stages_from_range,
                               unet_state_dict_from_flax)
from spcl_torch.ops import convstage_cuda as cs
from spcl_torch.training import batch_to_device, build_optimizer, build_pretrain_step
from test_torch_port_model import random_flax_unet
from test_torch_semi_step import _zero_stats
from torch_port_helpers import jax_dense_draws, jax_step_draws, nchw, to_torch

ROOT = Path(__file__).resolve().parents[1]
LR, WD = 1e-3, 1e-2
UNTIL = "Up_conv3"
HOOK = "infonce/Up_conv3/self"
TRAINABLE = ("Conv5", "Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3")
FROZEN = ("Conv1", "Conv2", "Conv3", "Conv4", "Up2", "Up_conv2", "Deconv_1x1")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dense_head_params(rng, c_in):
    def conv(i, o):
        return {"kernel": (rng.normal(size=(1, 1, i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": rng.normal(0.0, 0.1, (o,)).astype(np.float32)}
    return {"params": {"conv0": conv(c_in, 256), "conv1": conv(256, 256)}}


def _port_head(jparams, c_in, spatial=(10, 10)):
    head = DenseProjectionHead(c_in, hidden_dim=256, spatial_size=spatial)
    head.load_state_dict({k: torch.from_numpy(v)
                          for k, v in head_state_dict_from_flax(jparams).items()}, strict=True)
    return head


# ------------------------------------------------------------------ the head
@pytest.mark.parametrize("size,out", [(112, 10), (13, 10), (37, 5), (10, 10)])
def test_adaptive_avg_pool_bin_edges_match_spcl_tpu(size, out):
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), (out, out)))
    got = F.adaptive_avg_pool2d(torch.from_numpy(nchw(x)), (out, out)).numpy()
    np.testing.assert_allclose(got, nchw(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [112, 13])
def test_dense_head_matches_spcl_tpu(size):
    rng = np.random.default_rng(size)
    c_in = 16
    x = rng.normal(size=(2, size, size, c_in)).astype(np.float32)
    jparams = _dense_head_params(rng, c_in)
    jhead = JaxDenseHead(output_dim=256, hidden_dim=256, head_type="mlp", normalize=True,
                         spatial_size=(10, 10))
    want = np.asarray(jhead.apply(jparams, jnp.asarray(x)))
    got = _port_head(jparams, c_in)(torch.from_numpy(nchw(x))).detach().numpy()
    assert got.shape == (2, 256, 10, 10)
    np.testing.assert_allclose(got, nchw(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


# ------------------------------------------------------------------ the dense losses
def _loss_pair(sp, use_fused):
    """One decoder hook's loss in both packages on the same features, head
    and points: (jax loss, jax metrics, jax grads {head, feats}, port loss,
    port metrics, port head, port features)."""
    rng = np.random.default_rng(5)
    n, c, hw = 4, 32, 24
    feats = rng.normal(size=(2 * n, hw, hw, c)).astype(np.float32)
    jparams = _dense_head_params(rng, c)
    valid = np.array([1, 1, 1, 0], np.float32)
    key = jax.random.PRNGKey(11)
    k_flip, k_hooks = jax.random.split(key)
    flip = jaug.flip_params(k_flip, n, threshold=0.5)
    meta = {"partition": np.arange(n, dtype=np.int32) % 3,
            "patient": np.zeros(n, np.int32), "cycle": np.zeros(n, np.int32),
            "scan_idx": np.zeros(n, np.int32), "valid": valid}
    kw = dict(name=HOOK, feature_name=UNTIL, contrast_on="self", weight=0.5)
    if sp:
        kw.update(mode="soft", begin_value=4.0, end_value=4.0)
    scalars = {"gamma": 4.0} if sp else {}
    jhook = (JaxSPHook if sp else JaxHook)(use_fused=use_fused, **kw)

    def jloss(p, f):
        ctx = {"acts": {UNTIL: f}, "n_unl": n, "flip": flip, "key": k_hooks, "mesh": None,
               **{k: jnp.asarray(v) for k, v in meta.items()}}
        return jhook.loss_fn(p, ctx, scalars)

    (jl, jm), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(feats))

    hook = (SelfPacedINFONCEHook if sp else INFONCEHook)(use_fused=use_fused, **kw)
    hook.projector = _port_head(jparams, c)
    f = torch.from_numpy(nchw(feats)).requires_grad_(True)
    ctx = {"acts": {UNTIL: f}, "n_unl": n, "flip": to_torch(flip),
           "draws": {HOOK: jax_dense_draws(k_hooks, n, jhook)},
           **{k: torch.from_numpy(v) for k, v in meta.items()}}
    loss, m = hook.loss_fn(ctx, scalars)
    loss.backward()
    return jl, jm, jg, loss, m, hook.projector, f


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("sp", [False, True], ids=["infonce", "spinfonce_soft"])
@pytest.mark.parametrize("use_fused", ["auto", False], ids=["fused", "dense"])
def test_dense_infonce_loss_and_gradients_match_spcl_tpu(sp, use_fused):
    jl, jm, (jg_head, jg_feats), loss, m, head, f = _loss_pair(sp, use_fused)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    if sp:
        np.testing.assert_allclose(float(m["sp_weight"]), float(jm["sp_weight"]), rtol=1e-4)
        assert 0.0 < float(m["sp_weight"]) < 1.0  # the soft weights are at work
    for name in ("conv0", "conv1"):
        layer = getattr(head, name)
        want = jg_head["params"][name]
        assert _rel(layer.weight.grad.numpy(),
                    np.transpose(np.asarray(want["kernel"]), (3, 2, 0, 1))) <= 2e-4, name
        assert _rel(layer.bias.grad.numpy(), np.asarray(want["bias"])) <= 2e-4, name
    assert _rel(f.grad.numpy(), nchw(np.asarray(jg_feats))) <= 2e-4
    # the padded slice's features (both views) take no gradient
    assert not f.grad[3].any() and not f.grad[7].any()


def test_dense_points_pair_views_and_drop_padding():
    hook = INFONCEHook(name=HOOK, feature_name=UNTIL, contrast_on="self")
    assert not hook.is_encoder and hook.spatial_size == (10, 10)
    g = torch.Generator().manual_seed(0)
    ctx = {"n_unl": 3, "valid": torch.tensor([1.0, 0.0, 1.0])}
    draws = hook.sample(g, ctx)
    assert draws["ys"].shape == (3, 5) and int(draws["ys"].max()) < 10
    z1 = torch.randn(3, 256, 10, 10)
    s1, s2, target, valid = hook._dense_points(z1, z1 + 1, {**ctx, "draws": {HOOK: draws}})
    assert s1.shape == (15, 256) and torch.equal(s2, s1 + 1)
    assert torch.equal(s1[5], z1[1, :, draws["ys"][1, 0], draws["xs"][1, 0]])
    assert target.tolist() == [0, 1, 2, 3, 4] + [-1] * 5 + list(range(10, 15))
    assert valid.tolist() == [1.0] * 5 + [0.0] * 5 + [1.0] * 5


# ------------------------------------------------------------------ the step
def _random_flax_params(max_channel, seed):
    params, stats = random_flax_unet(np.random.default_rng(seed), max_channel=max_channel)
    head = _dense_head_params(np.random.default_rng(seed + 1),
                              UNet(max_channel=max_channel).channel_dim(UNTIL))
    return params, stats, head


def _lockstep(max_channel, layout, canvas, crop, steps, seed):
    params, stats, head = _random_flax_params(max_channel, seed)
    jpol = dataclasses.replace(jaug.ACDC_PRETRAIN, crop=crop)
    ppol = dataclasses.replace(aug.ACDC_PRETRAIN, crop=crop)
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=max_channel, small_c_layout=layout)
    jhook = JaxHook(name=HOOK, feature_name=UNTIL, contrast_on="self")
    tx = jax_build_optimizer(name="RAdam", lr=LR, weight_decay=WD)
    mask = stage_trainable_mask(params, stages_from_range("Conv5", UNTIL))
    state = create_train_state(model_params=params, batch_stats=stats,
                               hook_params={HOOK: head}, tx=tx)
    jstep = jax_build_pretrain_step(jnet, [jhook], tx, policy=jpol, total_freedom=False,
                                    until=UNTIL, grad_mask=mask)

    net = UNet(input_dim=1, num_classes=4, max_channel=max_channel, small_c_layout=layout)
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in unet_state_dict_from_flax(params, stats).items()},
                        strict=True)
    set_trainable_stages(net, stages_from_range("Conv5", UNTIL))
    hook = INFONCEHook(name=HOOK, feature_name=UNTIL, contrast_on="self")
    hook.build(net, "cpu")
    hook.projector.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in head_state_dict_from_flax(head).items()})
    opt = build_optimizer([p for p in net.parameters() if p.requires_grad] + hook.parameters(),
                          lr=LR, weight_decay=WD)
    step = build_pretrain_step(net, [hook], opt, policy=ppol, total_freedom=False, until=UNTIL)
    before = {k: v.clone() for k, v in net.state_dict().items()}

    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=canvas, seed=0)
    pds = synthetic_dataset("acdc", num_scans=4, canvas=canvas, seed=0)
    jit = iter(jax_contrastive_loader(jds, scan_sample_num=2, seed=3))
    pit = iter(create_contrastive_loader(pds, scan_sample_num=2, seed=3))
    records, batches = [], []
    cs.reset_launch_counts()
    for key in jax.random.split(jax.random.PRNGKey(seed + 7), steps):
        jb, pb = next(jit), next(pit)
        np.testing.assert_array_equal(nchw(jb["image"]), pb["image"])
        jb = jax.tree_util.tree_map(jnp.asarray, jb)
        n = jb["image"].shape[0]
        draws = jax_step_draws(key, n, jpol, canvas, sizes=jb["size"], total_freedom=False,
                               hooks=[jhook])
        state, jm = jstep(state, jb, key, {})
        pm = step(batch_to_device(pb, "cpu"), None, {}, params=draws)
        records.append((jax.device_get(jm), pm))
        batches.append((jb, key))
        if len(records) == 1:
            first = dict(jax=jax.device_get(state.params),
                         net={k: v.clone() for k, v in net.state_dict().items()},
                         head={k: v.clone() for k, v in hook.projector.state_dict().items()})

    def noisy_step(eps):
        """spcl_tpu's first step from the start, its input given `eps` noise."""
        jb, key = batches[0]
        img = np.asarray(jb["image"], np.float32) / 255.0
        img = img + eps * np.random.default_rng(1).normal(size=img.shape).astype(np.float32)
        fresh = create_train_state(model_params=params, batch_stats=stats,
                                   hook_params={HOOK: head}, tx=tx)
        return jax.device_get(jstep(fresh, {**jb, "image": jnp.asarray(img)}, key, {})[0])

    clean, noisy = noisy_step(0.0), noisy_step(1e-6)
    a = _updates(clean.params["model"], params, clean.params["hooks"][HOOK], head)
    b = _updates(noisy.params["model"], params, noisy.params["hooks"][HOOK], head)
    return dict(records=records, state=jax.device_get(state), params0=params, head0=head,
                net=net, hook=hook, before=before, first=first, launches=dict(cs.LAUNCHES),
                noise_moves={k: _rel(b[k], a[k]) for k in a})


@pytest.fixture(scope="module")
def nhwc_run():
    return _lockstep(128, "nhwc", 40, 32, 3, seed=0)


@pytest.fixture(scope="module")
def pallas_run():
    return _lockstep(256, "pallas", 40, 32, 1, seed=1)


def _runs(request, which):
    return request.getfixturevalue(f"{which}_run")


@pytest.mark.parametrize("which", ["nhwc", "pallas"])
def test_decoder_pretrain_losses_match_spcl_tpu(request, which):
    for jm, pm in _runs(request, which)["records"]:
        np.testing.assert_allclose(float(pm["reg_loss"]), float(jm["reg_loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(pm["hooks"][HOOK]["loss"]),
                                   float(jm["hooks"][HOOK]["loss"]), rtol=1e-4)


@pytest.mark.parametrize("which", ["nhwc", "pallas"])
def test_spcl_tpu_frozen_conv1_drifts_under_weight_decay(request, which):
    """ROADMAP C8: spcl_tpu masks Conv1's gradient to zero, then its chain
    adds weight_decay x p before RAdam, so the frozen weights shrink."""
    run = _runs(request, which)
    w0 = np.asarray(run["params0"]["Conv1"]["conv0"]["kernel"])
    w1 = np.asarray(run["state"].params["model"]["Conv1"]["conv0"]["kernel"])
    assert np.abs(w1).sum() < np.abs(w0).sum()
    assert not np.array_equal(w0, w1)


@pytest.mark.parametrize("which", ["nhwc", "pallas"])
def test_port_frozen_stages_stay_bit_equal(request, which):
    run = _runs(request, which)
    after = run["net"].state_dict()
    for name in FROZEN:
        for p_name, p in run["net"].stage(name).named_parameters():
            assert not p.requires_grad and p.grad is None
            key = f"_{name}.{p_name}"
            assert torch.equal(after[key], run["before"][key]), key
    for name in TRAINABLE:
        moved = [not torch.equal(p.detach(), run["before"][f"_{name}.{k}"])
                 for k, p in run["net"].stage(name).named_parameters()]
        assert all(moved), name


# relative L2 bounds of the updates; see the module docstring
GRAD_TOL, NEAR_CAP = 2e-4, 5e-4     # the head and Up_conv3, next to the loss
UPDATE_TOL, DEEP_CAP = 2e-2, 5e-2   # Conv5..Up3
NEAR = ("head", "Up_conv3")


def _group(key):
    """"_Up_conv3.conv.0.weight" -> "Up_conv3", "head.conv0.bias" -> "head"."""
    return key.split(".")[0].lstrip("_")


def _stage_noise(noise_moves):
    """{stage: the most any of its leaves moves in spcl_tpu under input noise}."""
    out = {}
    for k, v in noise_moves.items():
        out[_group(k)] = max(out.get(_group(k), 0.0), v)
    return out


def _tol(stage, noise, near):
    if near:
        return min(NEAR_CAP, max(GRAD_TOL, 1.5 * noise))
    return min(DEEP_CAP, max(UPDATE_TOL, 1.5 * noise))


def _updates(flax_after, flax_before, head_after, head_before):
    """{torch key: update} of every trainable leaf, from flax trees."""
    after = unet_state_dict_from_flax(flax_after, _zero_stats(flax_after))
    before = unet_state_dict_from_flax(flax_before, _zero_stats(flax_before))
    out = {k: after[k] - before[k] for k in after
           if k.split(".")[0][1:] in TRAINABLE and "running" not in k
           and "num_batches" not in k}
    h1, h0 = head_state_dict_from_flax(head_after), head_state_dict_from_flax(head_before)
    out.update({f"head.{k}": h1[k] - h0[k] for k in h1})
    return out


def _port_updates(run, net_state, head_state, keys):
    head0 = head_state_dict_from_flax(run["head0"])
    got = {k: (v - run["before"][k]).numpy() for k, v in net_state.items() if k in keys}
    got.update({f"head.{k}": v.numpy() - head0[k] for k, v in head_state.items()})
    return got


@pytest.mark.parametrize("which", ["nhwc", "pallas"])
def test_trainable_leaves_match_spcl_tpu(request, which):
    run = _runs(request, which)
    noise = _stage_noise(run["noise_moves"])
    first = run["first"]
    want = _updates(first["jax"]["model"], run["params0"], first["jax"]["hooks"][HOOK],
                    run["head0"])
    assert len(want) == 4 * 6 + 3 * 3 + 4  # Conv5, Up_conv5..3: 6 each; Up5..3: 3; head: 4
    got = _port_updates(run, first["net"], first["head"], want)
    # the first step: RAdam's update is lr x (gradient + weight_decay x p)
    for k, w in want.items():
        tol = _tol(_group(k), noise[_group(k)], _group(k) in NEAR)
        assert _rel(got[k], w) <= tol, ("first step", k, _rel(got[k], w), tol)
    # after the last step every leaf, the near-loss ones included, carries
    # the deep stages' first-step differences
    want = _updates(run["state"].params["model"], run["params0"],
                    run["state"].params["hooks"][HOOK], run["head0"])
    got = _port_updates(run, run["net"].state_dict(), run["hook"].projector.state_dict(), want)
    for k, w in want.items():
        tol = _tol(_group(k), noise[_group(k)], False)
        assert _rel(got[k], w) <= tol, ("last step", k, _rel(got[k], w), tol)


@pytest.mark.parametrize("which", ["nhwc", "pallas"])
def test_spcl_tpu_decoder_updates_move_under_input_noise(request, which):
    """What the update tolerances rest on: spcl_tpu's own first-step
    updates, with and without 1e-6 of input noise, differ by more than 2e-3
    (relative L2) in Conv5..Up_conv5, and by less in Up_conv3 and the head,
    next to the loss."""
    moves = _runs(request, which)["noise_moves"]
    deep = [v for k, v in moves.items() if k.startswith(("_Conv5", "_Up5", "_Up_conv5"))]
    near = [v for k, v in moves.items() if k.startswith(("_Up_conv3", "head"))]
    assert min(deep) > 2e-3, moves
    assert max(near) < min(deep), moves


@pytest.mark.parametrize("which", ["nhwc", "pallas"])
def test_running_statistics_match_spcl_tpu(request, which):
    """Every stage the forward ran updates its statistics in both packages,
    the frozen encoder's included; the stages past Up_conv3 keep theirs."""
    run = _runs(request, which)
    want = unet_state_dict_from_flax(run["state"].params["model"], run["state"].batch_stats)
    got = run["net"].state_dict()
    for k, v in want.items():
        if "running" not in k:
            continue
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-3, atol=1e-4, err_msg=k)
        moved = not torch.equal(got[k], run["before"][k])
        assert moved == (k.split(".")[0][1:] not in ("Up2", "Up_conv2")), k


def test_pallas_stages_run_forward_only(pallas_run):
    """On the CPU the wrappers take the plain versions, and count nothing;
    what the fused stages saw is read from the graph: no parameter of
    Conv1/Conv2 took a gradient and the step still trained Conv5 on."""
    assert sum(pallas_run["launches"].values()) == 0
    net = pallas_run["net"]
    assert net.small_c_layout == "pallas"
    assert all(p.grad is None for name in ("Conv1", "Conv2")
               for p in net.stage(name).parameters())
    assert all(p.grad is not None for p in net.stage("Conv5").parameters())


def test_main_pretrain_decoder_entry_point(tmp_path):
    from spcl_torch.main_pretrain_decoder import main
    from spcl_torch.training import load_checkpoint

    scores = main(["Arch.max_channel=32", "Data.synthetic=true", "Data.canvas=64",
                   "Data.crop=48", "Data.synthetic_scans=6", "Data.ratios=[1]",
                   "Trainer.num_batches=2", "Trainer.max_epoch=1",
                   f"Trainer.save_dir={tmp_path}", "--opt-path",
                   str(ROOT / "config" / "hooks" / "infonce_dense.yaml")], device="cpu")
    assert sorted(scores) == [1] and 0.0 <= scores[1] <= 1.0
    pre = load_checkpoint(str(tmp_path / "pre" / "last.ckpt"))
    UNet(max_channel=32).load_state_dict(pre["_model"], strict=True)
    assert sorted(pre["_hooks"]) == [HOOK]
    assert "conv0.weight" in pre["_hooks"][HOOK]
    assert (tmp_path / "tra_1" / "best.ckpt").exists()


@pytest.mark.parametrize("name", ["pretrain.yaml", "hooks/infonce_dense.yaml",
                                  "hooks/spinfonce.yaml"])
def test_chip_smoke_config_transcriptions_match_the_files(name):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from spcl_torch import CONFIG_PATH
    from spcl_torch.configure import ConfigManager
    from spcl_torch.utils.utils import yaml_load
    assert chip_smoke.CONFIG_FILES[name] == yaml_load(Path(CONFIG_PATH) / name)
    merged = ConfigManager(*[str(Path(CONFIG_PATH) / f) for f in chip_smoke.DECODER_FILES],
                           strict=False).parse_args([]).merged_config
    assert chip_smoke._merged(*chip_smoke.DECODER_FILES) == merged
