"""The gradient-cache pretrain step of spcl_torch (`training/gradcache.py`,
`Trainer.grad_cache`), on the CPU at UNet-128, canvas 48, crop 32, against
its own direct autograd and against spcl_tpu's `build_gradcache_pretrain_step`.

Tolerances:
- cached against direct, and one chunk against `build_pretrain_step`: the
  same float32 ops in another summation order (per-chunk gradients added
  in turn, against one backward); loss and sp_weight rtol 1e-6, every
  gradient rtol 5e-5 + atol 1e-6 (spcl_tpu's tests/test_gradcache.py holds
  its own at 5e-5 / 1e-5), the BatchNorm buffers to the bit (both run the
  same pass A);
- against spcl_tpu (transplanted weights, spcl_tpu's per-chunk draws
  injected): the bounds of tests/test_torch_port_pretrain.py — loss and
  sp_weight rtol 1e-4; gradients of Conv4, Conv5 and the heads relative L2
  2e-4, of Conv1-Conv3 2e-2 (float32 rounding flips ReLU and max-pool
  routing; spcl_tpu's own Conv1 gradient moves by 2e-2 under 1e-6 of input
  noise; measured 3e-5 everywhere at these shapes); the running statistics
  after the chunk chain rtol 1e-4, atol 1e-6 (forward values only);
- 2 gloo ranks x 1 chunk against 1 process x 2 chunks, deterministic
  geometry (crop = canvas, no rotation, flips or jitter), rank-local
  BatchNorm per chunk, row_sharded criterion: loss rtol 1e-6, gradients
  rtol 5e-5 + atol 1e-6 (the ranks' gradients are summed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.hooks.infonce import INFONCEHook as JaxINFONCEHook
from spcl_tpu.hooks.infonce import SelfPacedINFONCEHook as JaxSPHook
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_tpu.training.gradcache import \
    build_gradcache_pretrain_step as jax_build_gradcache_pretrain_step
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_torch.data import augment as aug
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.data.samplers import InfiniteRandomSampler
from spcl_torch.hooks import INFONCEHook, SelfPacedINFONCEHook
from spcl_torch.hooks.base import TrainerHook
from spcl_torch.models import (UNet, head_state_dict_from_flax, set_trainable_stages,
                               stages_from_range, unet_state_dict_from_flax)
from spcl_torch.parallel.mesh import spawn_local
from spcl_torch.training import (batch_to_device, build_gradcache_pretrain_step,
                                 build_optimizer, build_pretrain_step)

import torch_parallel_workers as workers
from test_torch_port_pretrain import _random_encoder, _random_head
from torch_port_helpers import jax_view_draws, to_torch

CANVAS, CROP, MAXC = 48, 32, 128
ENCODER = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
HOOKS = ("sp", "nce")


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    params, stats = _random_encoder(rng)
    return params, stats, {h: _random_head(rng, MAXC) for h in HOOKS}


def _batch(n=6, seed=0):
    """Host batch of n slices and the index vector it was made from."""
    ds = synthetic_dataset("acdc", num_scans=6, slices_per_scan=(6, 8), canvas=CANVAS, seed=0)
    idx = next(iter(InfiniteRandomSampler(ds, batch_size=n, seed=seed)))
    return ds.batch(idx)


def _port(params, stats, heads, num_chunks, policy=None, flip_threshold=0.8):
    """spcl_torch's UNet, two hooks, adam and the gradient-cache step."""
    net = UNet(input_dim=1, num_classes=4, max_channel=MAXC)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         unet_state_dict_from_flax(params, stats, allow_partial=True).items()},
                        strict=False)
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    hooks = [SelfPacedINFONCEHook(name="sp", feature_name="Conv5", contrast_on="partition",
                                  begin_value=50.0, end_value=5.0, mode="soft", max_epoch=2),
             INFONCEHook(name="nce", feature_name="Conv5", contrast_on="patient", weight=0.5)]
    for h in hooks:
        h.build(net, "cpu")
        h.projector.load_state_dict({k: torch.from_numpy(v) for k, v in
                                     head_state_dict_from_flax(heads[h.name]).items()})
    named = {k: v for k, v in net.named_parameters() if v.requires_grad}
    for h in hooks:
        named.update({f"{h.name}.{k}": v for k, v in h.projector.named_parameters()})
    opt = build_optimizer(list(named.values()), name="adam", lr=1e-3)
    policy = policy or aug.AugmentPolicy(crop=CROP, rot_degrees=10.0)
    step = build_gradcache_pretrain_step(net, hooks, opt, policy=policy, total_freedom=True,
                                         until="Conv5", num_chunks=num_chunks,
                                         flip_threshold=flip_threshold)
    scalars = {h.name: h.epoch_scalars(0) for h in hooks}
    return dict(net=net, hooks=hooks, named=named, opt=opt, step=step, scalars=scalars,
                policy=policy)


def _draws(gen_seed, n):
    """Whole-batch draws of the port's own generator."""
    g = torch.Generator().manual_seed(gen_seed)
    pol = aug.AugmentPolicy(crop=CROP, rot_degrees=10.0)
    return {"aug": aug.sample_twice(g, n, pol, CANVAS), "flip": aug.flip_params(g, n)}


def _grads(port, out):
    return dict(zip(port["named"], out["grads"]))


def _close(a, b, rtol=5e-5, atol=1e-6):
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("num_chunks", [1, 3])
def test_cached_equals_direct(num_chunks):
    port = _port(*_weights(), num_chunks=num_chunks)
    batch = batch_to_device(_batch(6), "cpu")
    draws = _draws(1, 6)
    before = [b.clone() for b in port["net"].buffers()]
    direct = port["step"].direct_value_and_grad(batch, None, port["scalars"], params=draws)
    cached = port["step"].cached_value_and_grad(batch, None, port["scalars"], params=draws)
    for b, s in zip(port["net"].buffers(), before):  # the oracles leave the model alone
        assert torch.equal(b, s)
    np.testing.assert_allclose(float(cached["loss"]), float(direct["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(cached["hooks"]["sp"]["sp_weight"]),
                               float(direct["hooks"]["sp"]["sp_weight"]), rtol=1e-6)
    for a, b in zip(cached["buffers"], direct["buffers"]):
        assert torch.equal(a, b)
    moved = [not torch.equal(a, b) for a, b in zip(cached["buffers"], before)]
    assert sum(moved) >= 3 * 5  # mean, var, count of both BN of every stage
    assert all(g is not None for g in cached["grads"])
    _close(_grads(port, cached), _grads(port, direct))


def test_one_chunk_equals_the_monolithic_step():
    weights = _weights()
    batch = batch_to_device(_batch(6), "cpu")
    draws = _draws(2, 6)
    runs = []
    for build in ("gradcache", "monolithic"):
        port = _port(*weights, num_chunks=1)
        step = port["step"] if build == "gradcache" else build_pretrain_step(
            port["net"], port["hooks"], port["opt"], policy=port["policy"], total_freedom=True,
            until="Conv5")
        metrics = step(batch, None, port["scalars"], params=draws)
        runs.append((metrics, {k: v.detach().clone() for k, v in port["named"].items()},
                     {k: v.clone() for k, v in port["net"].named_buffers()}))
    (m_gc, p_gc, b_gc), (m_mono, p_mono, b_mono) = runs
    np.testing.assert_allclose(float(m_gc["reg_loss"]), float(m_mono["reg_loss"]), rtol=1e-6)
    _close(p_gc, p_mono, rtol=1e-6, atol=1e-7)  # adam at lr 1e-3 after one step
    for k in b_mono:
        assert torch.equal(b_gc[k], b_mono[k]), k


def test_indivisible_batch_and_wrong_hooks_raise():
    port = _port(*_weights(), num_chunks=4)
    with pytest.raises(ValueError, match="batch size 6 not divisible by num_chunks=4"):
        port["step"](batch_to_device(_batch(6), "cpu"), torch.Generator(), port["scalars"])
    net, hook = port["net"], port["hooks"][0]
    kw = dict(policy=port["policy"], total_freedom=True, until="Up_conv3", num_chunks=2)
    decoder = SelfPacedINFONCEHook(name="dense", feature_name="Conv5")
    decoder.feature_name = "Up_conv3"  # the port refuses to build a decoder InfoNCE hook
    with pytest.raises(NotImplementedError, match="encoder"):
        build_gradcache_pretrain_step(net, [decoder], port["opt"], **kw)
    with pytest.raises(NotImplementedError, match="INFONCE"):
        build_gradcache_pretrain_step(net, [hook, TrainerHook("plain")], port["opt"], **kw)
    with pytest.raises(ValueError, match="num_chunks"):
        build_gradcache_pretrain_step(net, [hook], port["opt"], **{**kw, "num_chunks": 0})


# ------------------------------------------------------------------ against spcl_tpu
def _jax_chunk_draws(key, batch, num_chunks, policy):
    """spcl_tpu's per-chunk draws (gradcache.py:123-129: keys folded with the
    chunk index) concatenated into one whole-batch `params` for the port."""
    k_aug, k_flip, _ = jax.random.split(key, 3)
    n = batch["image"].shape[0]
    m = n // num_chunks
    parts = []
    for c in range(num_chunks):
        sizes = jnp.asarray(batch["size"][c * m:(c + 1) * m])
        parts.append({"aug": jax_view_draws(jax.random.fold_in(k_aug, c), m, policy, CANVAS,
                                            sizes),
                      "flip": to_torch(jaug.flip_params(jax.random.fold_in(k_flip, c), m,
                                                        threshold=0.8))})

    def cat(*xs):
        if isinstance(xs[0], dict):
            return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
        if isinstance(xs[0], tuple):
            return tuple(cat(*z) for z in zip(*xs))
        return torch.cat(xs)

    return cat(*parts)


@pytest.fixture(scope="module")
def jax_pair():
    """One cached value and gradient of each package: 12 slices in 2 chunks,
    the same weights, batch and per-chunk draws. (Chunks of 2 slices leave
    Conv5's BatchNorm 16 values a channel, where spcl_tpu's variance,
    E[x^2] - mean^2, moves the encoder gradients by 2%.)"""
    params, stats, heads = _weights()
    host = _batch(12)
    num_chunks = 2
    key = jax.random.PRNGKey(3)
    jpol = dataclasses.replace(jaug.AugmentPolicy(crop=CROP, rot_degrees=10.0))
    jhooks = [JaxSPHook(name="sp", feature_name="Conv5", contrast_on="partition",
                        begin_value=50.0, end_value=5.0, mode="soft", max_epoch=2,
                        use_fused=False),
              JaxINFONCEHook(name="nce", feature_name="Conv5", contrast_on="patient",
                             weight=0.5, use_fused=False)]
    tx = jax_build_optimizer(name="adam", lr=1e-3)
    state = create_train_state(model_params=params, batch_stats=stats, hook_params=heads, tx=tx)
    jstep = jax_build_gradcache_pretrain_step(
        JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC), jhooks, tx, policy=jpol,
        total_freedom=True, until="Conv5", num_chunks=num_chunks)
    jbatch = {k: jnp.asarray(np.transpose(v, (0, 2, 3, 1)) if k == "image" else v)
              for k, v in host.items()}  # spcl_tpu's images are NHWC
    scalars = {h.name: h.epoch_scalars(0) for h in jhooks}
    (jloss, (jstats, jmetrics)), jgrads = jstep.cached_value_and_grad(state, jbatch, key, scalars)

    port = _port(params, stats, heads, num_chunks=num_chunks)
    draws = _jax_chunk_draws(key, host, num_chunks, jpol)
    out = port["step"].cached_value_and_grad(batch_to_device(host, "cpu"), None,
                                             port["scalars"], params=draws)
    return dict(jloss=float(jloss), jstats=jax.device_get(jstats), jmetrics=jmetrics,
                jgrads=jax.device_get(jgrads), port=port, out=out)


def test_loss_matches_spcl_tpu(jax_pair):
    s = jax_pair
    np.testing.assert_allclose(float(s["out"]["loss"]), s["jloss"], rtol=1e-4)
    np.testing.assert_allclose(float(s["out"]["hooks"]["sp"]["sp_weight"]),
                               float(s["jmetrics"]["sp"]["sp_weight"]), rtol=1e-4)


def _flax_grad_paths():
    for name in ENCODER:
        for i, (c, b) in enumerate(((0, 1), (3, 4))):
            yield (f"_{name}.conv.{c}.weight", ("model", name, f"conv{i}", "kernel"),
                   lambda w: np.transpose(w, (3, 2, 0, 1)))
            yield f"_{name}.conv.{b}.weight", ("model", name, f"bn{i}", "scale"), lambda w: w
            yield f"_{name}.conv.{b}.bias", ("model", name, f"bn{i}", "bias"), lambda w: w
    for h in HOOKS:
        for fc in ("fc0", "fc1"):
            yield f"{h}.{fc}.weight", ("hooks", h, "params", fc, "kernel"), lambda w: w.T
            yield f"{h}.{fc}.bias", ("hooks", h, "params", fc, "bias"), lambda w: w


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def test_every_gradient_matches_spcl_tpu(jax_pair):
    grads = _grads(jax_pair["port"], jax_pair["out"])
    rels = {}
    for key, path, layout in _flax_grad_paths():
        want = layout(_get(jax_pair["jgrads"], path))
        got = grads[key].numpy()
        rels[key] = (float(np.linalg.norm(got - want) / np.linalg.norm(want)),
                     2e-2 if path[1] in ("Conv1", "Conv2", "Conv3") else 2e-4)
    assert len(rels) == len(grads) == 5 * 6 + 2 * 4
    assert all(r <= tol for r, tol in rels.values()), \
        " ".join(f"{k}={r:.1e}/{tol:.0e}" for k, (r, tol) in rels.items())


def test_running_statistics_chain_like_spcl_tpu(jax_pair):
    net = jax_pair["port"]["net"]
    after = dict(zip([k for k, _ in net.named_buffers()], jax_pair["out"]["buffers"]))
    for name in ENCODER:
        for i, b in enumerate((1, 4)):
            for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
                np.testing.assert_allclose(
                    after[f"_{name}.conv.{b}.{ours}"].numpy(),
                    jax_pair["jstats"][name][f"bn{i}"][theirs], rtol=1e-4, atol=1e-6,
                    err_msg=f"{name} bn{i} {ours}")
            assert int(after[f"_{name}.conv.{b}.num_batches_tracked"]) == 2  # one per chunk


# ------------------------------------------------------------------ ranks
def test_two_ranks_one_chunk_equal_one_process_two_chunks():
    """spcl_tpu's test_mesh_gradcache_absolute_vs_single_device: in
    deterministic geometry, 2 ranks x 1 chunk see the same chunks as 1
    process x 2 chunks, so loss and summed gradients are the same."""
    params, stats, heads = _weights()
    sd = unet_state_dict_from_flax(params, stats, allow_partial=True)
    head = head_state_dict_from_flax(heads["sp"])
    batch = _batch(8)
    ranks = spawn_local(2, workers.gradcache_worker, (sd, head, batch, 1), device="cpu",
                        timeout_s=300.0, collective_timeout_s=120.0)
    one = workers.gradcache_worker(sd, head, batch, 2)  # no process group here
    for got in ranks:
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["sp_weight"], one["sp_weight"], rtol=1e-6)
        assert sorted(got["grads"]) == sorted(one["grads"])
        for k, g in one["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=5e-5, atol=1e-6, err_msg=k)
    for k in one["grads"]:  # the ranks end with the same summed gradient, to the bit
        np.testing.assert_array_equal(ranks[0]["grads"][k], ranks[1]["grads"][k])


# ------------------------------------------------------------------ the trainer
def test_trainer_grad_cache_through_build_trainer(tmp_path):
    from spcl_torch.entry import build_trainer
    from spcl_torch.training import load_model_state_dict
    from spcl_torch.utils import fix_all_seed
    from test_torch_port_pretrain import _small_config

    config = _small_config(tmp_path)
    config["Arch"]["max_channel"] = 64
    config["Trainer"]["grad_cache"] = 2  # 2 scans x 3 partitions = 6 slices, 3 a chunk
    fix_all_seed(10)
    trainer = build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")
    trainer.init()
    assert trainer._train_step.num_chunks == 2
    conv1 = trainer.model._Conv1.conv[0].weight.detach().clone()
    tracked = int(trainer.model._Conv1.conv[1].num_batches_tracked)
    trainer.start_training()
    assert len(trainer.step_metrics) == 2
    assert all(np.isfinite(m["reg_loss"]) for m in trainer.step_metrics)
    assert not torch.equal(trainer.model._Conv1.conv[0].weight, conv1)
    # pass A chains the statistics (2 chunks a step); pass B leaves them
    assert int(trainer.model._Conv1.conv[1].num_batches_tracked) == tracked + 2 * 2
    UNet(max_channel=64).load_state_dict(load_model_state_dict(str(tmp_path / "last.ckpt")),
                                         strict=True)
