"""spcl_torch's effect study and feature probe against spcl_tpu's, on the CPU.

- Configs: for every arm and both phases, `spcl_torch.scripts.effect_study`
  builds the configs of `scripts/effect_study.py` key for key (loaded from
  its file; its run_arm alone imports jax).
- Corrupted meta-labels: `corrupt_meta_labels(synthetic_dataset_hard(...),
  0.8, seed=777)` equal to spcl_tpu's to the bit, and so the (corrupted
  or clean) training set each study pretrain config loads.
- Probe: `probe_accuracy` equal to spcl_tpu's to the bit on the same
  features; `embed_dataset` of one UNet-128 checkpoint (random weights and
  running statistics, written in each package's format) within 1e-4
  relative L2 of spcl_tpu's.
- One pretrain step at the study's own pretrain config (spsoft_corrupt:
  UNet-128, crop 48 of 64, `synthetic: hard`, `meta_corrupt: 0.8`, Adam
  1e-3, SP soft gamma 8 -> 40, the first contrastive batch: 30 slices, 2N =
  60) against spcl_tpu's, from transplanted weights with the JAX step's own
  draws injected; the gamma schedule over the study's 15 epochs equal.
  The step is held at spsoft_corrupt and at plain_clean (plain InfoNCE on
  clean meta-labels). Tolerances: loss and sp_weight rtol 1e-4; gradients
  the two bounds of tests/test_torch_port_pretrain.py, relative L2 2e-4,
  and 2e-2 where 1e-5 forward differences flip ReLU and max-pool routing:
  Conv1-Conv3 there; here every tensor whose gradient spcl_tpu itself moves
  by 1e-4 or more under 1e-6 input noise (Conv1-Conv4, and Conv5 under
  plain InfoNCE), never the head; and every tensor within 2e-4 + twice
  spcl_tpu's own move.
  Updated parameters: Adam's first step moves every
  entry by lr x g / (|g| + eps), that is by +-lr whatever |g| is, so an
  entry whose gradient lies within the gradient's own error of 0 can move
  +lr in one package and -lr in the other, and one whose |g| is near eps
  moves by a share of lr that the gradient's error changes. So each entry
  is held to lr x |u(g_port) - u(g_jax)| + 1e-6 with u(g) = g / (|g| +
  eps) and g_jax the gradient spcl_tpu's step applied (read from its Adam
  state): atol 1e-6 wherever the gradients give one direction; the entries
  further apart, and the sign flips, are each at most 1e-3 of all, and a
  sign flips only where |g| is below its tensor's gradient bound times the
  L2 norm of its gradient.
- One fine-tune step at the study's fine-tune config (UNet-128, crop 48, 2
  labeled scans, batch 8, Adam 1e-3) against spcl_tpu's: the same first
  labeled batch, the JAX draws injected; loss, Dice counts and the update.
- Slow (not in tier-1): the whole pretraining of plain_corrupt, sp_clean
  and sp_corrupt at seed 10 in both packages, whose projections collapse to
  one fixed point (spcl_tpu's by epoch 3); the port's last three epoch
  losses within 1e-4 relative of spcl_tpu's.
- `run_arm` on the CPU at 1 epoch x 2 batches a phase, for `scratch` and
  `spsoft_corrupt`: spcl_tpu's record keys, a finite pretrain loss (None
  for scratch), a pre/last.ckpt that reloads strictly, `collect` and the
  gate over the records; the orchestrator collects what its workers wrote
  and raises on a worker that fails.
- Backends: `run_arm` trains inside `backend_corner` of one of four
  corners (cuDNN deterministic or not, TF32 in cuDNN or not; matmul TF32
  off in each), refuses any other, and restores the settings after; the
  record names its corner, and `--backends` reaches the workers. `pair`
  holds two record folders seed by seed and by the gate's rule.

Torch runs on one thread (module fixture). The slow study on the card is
`tests/test_torch_port_cuda.py::test_effect_study_on_the_card`.
"""
import ast
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import corrupt_meta_labels as jax_corrupt
from spcl_tpu.data import synthetic_dataset_hard as jax_hard
from spcl_tpu.data.creator import create_contrastive_loader as jax_contrastive_loader
from spcl_tpu.entry.common import load_datasets_from_config as jax_load_datasets
from spcl_tpu.hooks import create_hook_from_config as jax_create_hooks
from spcl_tpu.hooks.base import get_individual_hooks as jax_individual_hooks
from spcl_tpu.models.masking import stage_trainable_mask
from spcl_tpu.models.torch_import import flax_from_torch_state_dict, write_warm_start
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_tpu.training.steps import build_pretrain_step as jax_build_pretrain_step
from spcl_torch.data import augment as aug
from spcl_torch.data.creator import create_contrastive_loader
from spcl_torch.data.packing import corrupt_meta_labels, synthetic_dataset_hard
from spcl_torch.entry.common import load_datasets_from_config
from spcl_torch.hooks import create_hook_from_config, get_individual_hooks
from spcl_torch.models import (UNet, head_state_dict_from_flax, set_trainable_stages,
                               stages_from_range, unet_state_dict_from_flax)
from spcl_torch.scripts import effect_study as es
from spcl_torch.scripts import probe_pretrain_features as probe
from spcl_torch.training import (batch_to_device, build_optimizer, build_pretrain_step,
                                 load_model_state_dict, save_checkpoint)
from torch_port_helpers import jax_step_draws, nchw

ROOT = Path(__file__).resolve().parents[1]
MAXC = 128
ENCODER = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
STEP_ARM = "spsoft_corrupt"
# the pretrain step is held at both hooks of the study: SP soft on corrupted
# meta-labels, and plain InfoNCE on clean ones (the arm furthest from
# spcl_tpu's table on the card)
STEP_ARMS = ("spsoft_corrupt", "plain_clean")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_study():
    return _load_script("effect_study")


@pytest.fixture(scope="module")
def jax_probe():
    return _load_script("probe_pretrain_features")


# ---------------------------------------------------------------- configs
CONFIG_CASES = [(a, p) for a in es.ARMS for p in ("pre", "ft")
                if not (p == "pre" and es.ARMS[a]["pre"] is None)]


@pytest.mark.parametrize("arm,phase", CONFIG_CASES)
def test_configs_equal_spcl_tpu_key_for_key(jax_study, arm, phase):
    assert es.ARMS == jax_study.ARMS
    assert es.SEEDS == jax_study.SEEDS and es.CORRUPT == jax_study.CORRUPT
    assert (es.CANVAS, es.CROP, es.PRE_EPOCHS, es.PRE_BATCHES, es.FT_EPOCHS, es.FT_BATCHES,
            es.LABELED_SCANS) == (jax_study.CANVAS, jax_study.CROP, jax_study.PRE_EPOCHS,
                                  jax_study.PRE_BATCHES, jax_study.FT_EPOCHS,
                                  jax_study.FT_BATCHES, jax_study.LABELED_SCANS)
    spec = es.ARMS[arm]["pre"]
    if phase == "pre":
        args = (10, spec["sp"], spec["corrupt"], "runs/x/pre")
        got, want = es.pretrain_config(*args), jax_study.pretrain_config(*args)
        bf16 = es.pretrain_config(*args, "bfloat16")
    else:
        args = (10, None if spec is None else "runs/x/pre/last.ckpt", "runs/x/ft")
        got, want = es.finetune_config(*args), jax_study.finetune_config(*args)
        bf16 = es.finetune_config(*args, "bfloat16")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    # bfloat16 changes Arch.dtype and nothing else
    assert bf16["Arch"].pop("dtype") == "bfloat16"
    got["Arch"].pop("dtype")
    assert bf16 == got


# ---------------------------------------------------------------- meta-labels
@pytest.fixture(scope="module")
def hard_sets():
    """(spcl_tpu's, the port's) study training set, before corruption."""
    return (jax_hard("acdc", num_scans=20, canvas=es.CANVAS, seed=0),
            synthetic_dataset_hard("acdc", num_scans=20, canvas=es.CANVAS, seed=0))


def test_corrupted_meta_labels_equal_spcl_tpu(hard_sets):
    jds, pds = hard_sets
    assert np.array_equal(jds.images, pds.images)
    jc = jax_corrupt(jds, es.CORRUPT, seed=777)
    pc = corrupt_meta_labels(pds, es.CORRUPT, seed=777)
    assert pc.partitions.dtype == jc.partitions.dtype and pc.cycles.dtype == jc.cycles.dtype
    assert np.array_equal(pc.partitions, jc.partitions)
    assert np.array_equal(pc.cycles, jc.cycles)
    changed = np.mean(pc.partitions != pds.partitions)
    assert 0.4 < changed < 0.7  # 80% redrawn of 3 partitions: ~53% differ
    # the segmentation labels and the clean copy stay as they were
    assert np.array_equal(pc.labels, pds.labels)
    assert not np.array_equal(pc.partitions, pds.partitions)
    # and the study's pretrain config loads exactly these
    spec = es.ARMS[STEP_ARM]["pre"]
    cfg = es.pretrain_config(10, spec["sp"], spec["corrupt"], "unused")
    ptra, _ = load_datasets_from_config(cfg)
    jtra, _ = jax_load_datasets(cfg)
    assert np.array_equal(ptra.partitions, pc.partitions)
    assert np.array_equal(jtra.partitions, pc.partitions)
    assert np.array_equal(ptra.cycles, jtra.cycles)
    # and a clean arm's config the clean ones
    spec = es.ARMS["plain_clean"]["pre"]
    cfg = es.pretrain_config(10, spec["sp"], spec["corrupt"], "unused")
    for tra in (load_datasets_from_config(cfg)[0], jax_load_datasets(cfg)[0]):
        assert np.array_equal(tra.partitions, pds.partitions)
        assert np.array_equal(tra.cycles, pds.cycles)


# ---------------------------------------------------------------- probe
def _random_unet_state(rng):
    """A port UNet-128 state_dict drawn with numpy: He-scaled kernels, BN
    affine near 1 / 0, running statistics away from their init."""
    sd = {}
    for k, v in UNet(max_channel=MAXC).state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros((), np.int64)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            sd[k] = rng.normal(0.0, 0.1, shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        elif len(shape) == 1:
            sd[k] = rng.normal(1.0, 0.1, shape).astype(np.float32)
        else:
            sd[k] = (rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[1:]))
                     ).astype(np.float32)
    return sd


PROBE_CANVAS, PROBE_CROP = 40, 32  # the embedding test's cut: fewer pixels, same slices


@pytest.fixture(scope="module")
def embeddings(tmp_path_factory, jax_probe):
    """spcl_tpu's and the port's embed_dataset of the same weights, each
    loaded from a checkpoint in its own package's format."""
    d = tmp_path_factory.mktemp("probe")
    sd = _random_unet_state(np.random.default_rng(0))
    params, stats = flax_from_torch_state_dict(sd)
    write_warm_start(str(d / "jax.ckpt"), params, stats)
    save_checkpoint(str(d / "port.ckpt"), {"_model": {k: torch.from_numpy(v)
                                                      for k, v in sd.items()}})
    jf, jds = jax_probe.embed_dataset(str(d / "jax.ckpt"), PROBE_CANVAS, PROBE_CROP)
    pf, pds = probe.embed_dataset(str(d / "port.ckpt"), PROBE_CANVAS, PROBE_CROP, "cpu")
    return jf, jds, pf, pds


def test_embed_dataset_matches_spcl_tpu(embeddings):
    jf, jds, pf, pds = embeddings
    assert pf.shape == jf.shape == (len(pds.partitions), MAXC) and pf.dtype == np.float32
    assert np.array_equal(pds.partitions, jds.partitions)
    assert np.array_equal(pds.patient_index, jds.patient_index)
    rel = np.linalg.norm(pf - jf) / np.linalg.norm(jf)
    assert rel <= 1e-4, rel
    assert np.all(np.isfinite(pf)) and float(np.std(pf)) > 0


def test_probe_accuracy_equals_spcl_tpu_to_the_bit(embeddings, jax_probe):
    jf, jds, pf, pds = embeddings
    for feats in (pf, jf, np.random.default_rng(1).normal(size=pf.shape).astype(np.float32)):
        got = probe.probe_accuracy(feats, pds)
        assert got == jax_probe.probe_accuracy(feats, jds)
        assert 0.0 <= got <= 1.0


# ---------------------------------------------------------------- one pretrain step
def _flax_head(rng, c_in):
    def dense(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": rng.normal(0.0, 0.1, (o,)).astype(np.float32)}
    return {"params": {"fc0": dense(c_in, 256), "fc1": dense(256, 256)}}


@pytest.fixture(scope="module", params=STEP_ARMS)
def step_pair(request):
    """One pretrain step of each package at an arm's pretrain config of the
    study: the same (corrupted) dataset and first contrastive batch, the
    same weights, the JAX step's draws injected into the port's."""
    spec = es.ARMS[request.param]["pre"]
    cfg = es.pretrain_config(10, spec["sp"], spec["corrupt"], "unused")
    cl = cfg["ContrastiveLoaderParams"]
    jtra, _ = jax_load_datasets(cfg)
    ptra, _ = load_datasets_from_config(cfg)
    loader_kw = dict(scan_sample_num=cl["scan_sample_num"],
                     partition_sample_num=cl["partition_sample_num"], seed=cfg["RandomSeed"])
    jbatch = next(iter(jax_contrastive_loader(jtra, **loader_kw)))
    pbatch = next(iter(create_contrastive_loader(ptra, **loader_kw)))
    max_epoch = cfg["Trainer"]["max_epoch"]
    (jhook,) = jax_individual_hooks(*jax_create_hooks(cfg, max_epoch=max_epoch))
    (hook,) = get_individual_hooks(*create_hook_from_config(cfg, max_epoch=max_epoch))
    scalars_e1 = hook.epoch_scalars(0)  # the first epoch's: gamma, or none
    lr = cfg["Optim"]["lr"]
    n = jbatch["image"].shape[0]
    key = jax.random.PRNGKey(42)
    rng = np.random.default_rng(0)
    sd = _random_unet_state(rng)
    params, stats = flax_from_torch_state_dict(sd)
    params = {k: params[k] for k in ENCODER}
    stats = {k: stats[k] for k in ENCODER}
    head = _flax_head(rng, MAXC)

    # ---- spcl_tpu
    jpol = dataclasses.replace(jaug.ACDC_PRETRAIN, crop=es.CROP)
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC)
    tx = jax_build_optimizer(name=cfg["Optim"]["name"], lr=lr)
    mask = stage_trainable_mask(params, stages_from_range(None, "Conv5"))
    state = create_train_state(model_params=params, batch_stats=stats,
                               hook_params={jhook.name: head}, tx=tx)
    jbatch_dev = jax.tree_util.tree_map(jnp.asarray, jbatch)
    scalars = {jhook.name: {k: jnp.float32(v) for k, v in scalars_e1.items()}}

    def loss_fn(p, image):  # spcl_tpu/training/steps.py:420-445, spelled out for grads
        k_aug, k_flip, k_hooks = jax.random.split(key, 3)
        (v1, _), (v2, _) = jaug.augment_twice(k_aug, image, None, jpol, total_freedom=True,
                                              sizes=jbatch_dev["size"])
        fp = jaug.flip_params(k_flip, n, threshold=0.8)
        v2 = jaug.apply_flip(v2, fp)
        acts, _ = jnet.apply({"params": p["model"], "batch_stats": stats},
                             jnp.concatenate([v1, v2]), train=True, until="Conv5",
                             mutable=["batch_stats"])
        ctx = {"acts": acts, "n_unl": n, "flip": fp, "mesh": None, "key": k_hooks,
               **{k: jbatch_dev[k] for k in ("partition", "patient", "cycle", "scan_idx",
                                             "valid")}}
        return jhook.loss_fn(p["hooks"][jhook.name], ctx, scalars[jhook.name])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    image = jbatch_dev["image"].astype(jnp.float32) / 255.0
    (jloss, jm), jgrads = grad_fn(state.params, image)
    # spcl_tpu's own gradient under 1e-6 input noise: how far float32
    # rounding alone moves each tensor's gradient in this configuration
    noise = jnp.asarray(np.random.default_rng(5).normal(0.0, 1e-6, image.shape), jnp.float32)
    _, jgrads_noisy = grad_fn(state.params, image + noise)
    jstep = jax_build_pretrain_step(jnet, [jhook], tx, policy=jpol, total_freedom=True,
                                    until="Conv5", grad_mask=mask)
    new_state, jmetrics = jstep(state, jbatch_dev, key, scalars)

    # ---- spcl_torch
    net = UNet(input_dim=1, num_classes=4, max_channel=MAXC)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         unet_state_dict_from_flax(params, stats, allow_partial=True).items()},
                        strict=False)
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    hook.build(net, "cpu")
    hook.projector.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in head_state_dict_from_flax(head).items()})
    ps = [p for p in net.parameters() if p.requires_grad] + hook.parameters()
    opt = build_optimizer(ps, name=cfg["Optim"]["name"], lr=lr)
    ppol = dataclasses.replace(aug.ACDC_PRETRAIN, crop=es.CROP)
    step = build_pretrain_step(net, [hook], opt, policy=ppol, total_freedom=True,
                               until="Conv5")
    draws = jax_step_draws(key, n, jpol, es.CANVAS, sizes=jbatch_dev["size"])
    metrics = step(batch_to_device(pbatch, "cpu"), None, {hook.name: scalars_e1},
                   params=draws)
    return dict(jloss=float(jloss), jm=jm, jgrads=jgrads, jgrads_noisy=jgrads_noisy,
                new_state=new_state,
                jmetrics=jmetrics, metrics=metrics, net=net, hook=hook, jhook=jhook,
                jbatch=jbatch, pbatch=pbatch, scalars=scalars_e1, lr=lr, max_epoch=max_epoch,
                arm=request.param)


def _port_tensors(net, hook):
    """{(scope, flax path): (port tensor, flax -> torch layout)}"""
    out = {}
    for name in ENCODER:
        block = net.stage(name).conv
        for i, (conv, bn) in enumerate(((block[0], block[1]), (block[3], block[4]))):
            out[("model", name, f"conv{i}", "kernel")] = (
                conv.weight, lambda w: np.transpose(w, (3, 2, 0, 1)))
            out[("model", name, f"bn{i}", "scale")] = (bn.weight, lambda w: w)
            out[("model", name, f"bn{i}", "bias")] = (bn.bias, lambda w: w)
    for fc in ("fc0", "fc1"):
        layer = getattr(hook.projector, fc)
        out[("hooks", hook.name, "params", fc, "kernel")] = (layer.weight, lambda w: w.T)
        out[("hooks", hook.name, "params", fc, "bias")] = (layer.bias, lambda w: w)
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


# tests/test_torch_port_pretrain.py's two bounds: 2e-2 where float32 rounding
# flips ReLU and max-pool routing, 2e-4 elsewhere. There (32^2, one SP
# config) that is Conv1-Conv3; here it is read off spcl_tpu itself: a tensor
# whose gradient spcl_tpu moves by NOISE_MOVE_ROUTED or more (relative L2)
# under 1e-6 input noise takes 2e-2 (at 48^2 Conv4 runs at 6 x 6, and plain
# InfoNCE's many positives make Conv5 as sensitive). On top, every tensor
# stays within 2e-4 + twice spcl_tpu's own move.
NOISE_MOVE_ROUTED = 1e-4


def _noise_move(s, path, layout):
    want = layout(_get(s["jgrads"], path))
    noisy = layout(_get(s["jgrads_noisy"], path))
    return np.linalg.norm(noisy - want) / np.linalg.norm(want)


def _grad_tol(s, path, layout):
    return 2e-2 if _noise_move(s, path, layout) >= NOISE_MOVE_ROUTED else 2e-4


def test_study_step_batch_and_gamma_schedule_match(step_pair):
    s = step_pair
    assert np.array_equal(nchw(s["jbatch"]["image"]), np.asarray(s["pbatch"]["image"]))
    for k in ("partition", "patient", "cycle", "scan_idx", "valid", "size"):
        assert np.array_equal(np.asarray(s["jbatch"][k]), np.asarray(s["pbatch"][k])), k
    assert s["pbatch"]["image"].shape[0] == 30  # 10 scans x 3 partitions: 2N = 60
    assert s["hook"].name == s["jhook"].name
    assert type(s["hook"]).__name__ == type(s["jhook"]).__name__
    for e in range(s["max_epoch"]):
        assert s["hook"].epoch_scalars(e) == s["jhook"].epoch_scalars(e)
    # spsoft: the soft gamma 8 -> 40 starts at 8; plain InfoNCE has no schedule
    assert s["scalars"] == ({"gamma": 8.0} if s["arm"] == "spsoft_corrupt" else {})


def test_study_step_loss_and_sp_weight_match(step_pair):
    s = step_pair
    name = s["hook"].name
    np.testing.assert_allclose(float(s["metrics"]["reg_loss"]), s["jloss"], rtol=1e-4)
    np.testing.assert_allclose(float(s["jmetrics"]["reg_loss"]), s["jloss"], rtol=1e-6)
    if s["arm"] == "plain_clean":
        assert "sp_weight" not in s["metrics"]["hooks"][name] and "sp_weight" not in s["jm"]
        return
    sp = float(s["metrics"]["hooks"][name]["sp_weight"])
    np.testing.assert_allclose(sp, float(s["jm"]["sp_weight"]), rtol=1e-4)
    assert 0.0 < sp < 1.0  # soft weights at gamma 8: neither all kept nor all dropped


def test_study_step_every_gradient_matches(step_pair):
    s = step_pair
    tensors = _port_tensors(s["net"], s["hook"])
    assert len(tensors) == 5 * 6 + 4  # every encoder and head parameter
    routed = set()
    for path, (t, layout) in tensors.items():
        want = layout(_get(s["jgrads"], path))
        rel = np.linalg.norm(t.grad.numpy() - want) / np.linalg.norm(want)
        moved = _noise_move(s, path, layout)
        assert rel <= _grad_tol(s, path, layout), (path, rel, moved)
        assert rel <= 2e-4 + 2 * moved, (path, rel, moved)
        if moved >= NOISE_MOVE_ROUTED:
            routed.add(path[1])
    # the stages pretrain.py's test routes, and never the head
    assert {"Conv1", "Conv2", "Conv3"} <= routed and s["hook"].name not in routed, routed


ADAM_EPS = 1e-8  # optax's, outside the root, as the port's Adam
ADAM_B1 = 0.9


def _adam_direction(g):
    """Adam's first update over lr: bias-corrected m = g, v = g^2."""
    return g / (np.abs(g) + ADAM_EPS)


def test_study_step_adam_update_matches(step_pair):
    s = step_pair
    tensors = _port_tensors(s["net"], s["hook"])
    # the gradient spcl_tpu's step applied, from its Adam state (mu = (1 - b1) g)
    mu = s["new_state"].opt_state[0].mu
    apart = flips = 0
    for path, (t, layout) in tensors.items():
        want = layout(_get(s["new_state"].params, path))
        got = t.detach().numpy()
        gp = t.grad.numpy()
        gj = layout(_get(mu, path)) / (1 - ADAM_B1)
        tol = _grad_tol(s, path, layout)
        rel = np.linalg.norm(gj - layout(_get(s["jgrads"], path))) / np.linalg.norm(gj)
        assert rel <= tol, (path, rel)  # the step's gradient is the one held above
        du = s["lr"] * np.abs(_adam_direction(gp) - _adam_direction(gj))
        np.testing.assert_array_less(np.abs(got - want), du + 1e-6, err_msg=str(path))
        # a sign apart only within the gradient's error of 0
        flip = np.sign(gp) != np.sign(gj)
        assert np.all(np.abs(gj[flip]) <= tol * np.linalg.norm(gj)), path
        apart += int((du > 1e-6).sum())
        flips += int(flip.sum())
    n = sum(t.numel() for t, _ in tensors.values())
    assert apart <= 1e-3 * n and flips <= 1e-3 * n, (apart, flips, n)


# ---------------------------------------------------------------- one fine-tune step
@pytest.fixture(scope="module")
def finetune_pair():
    """One fine-tune step of each package at the study's fine-tune config
    (UNet-128, crop 48 of 64, 2 labeled scans, batch 8, Adam 1e-3): the same
    first labeled batch, random weights transplanted, the JAX step's draws
    injected."""
    from spcl_tpu.data.creator import get_data as jax_get_data
    from spcl_tpu.losses.functional import class2one_hot as jax_one_hot
    from spcl_tpu.training.steps import _masked_ce as jax_masked_ce
    from spcl_tpu.training.steps import build_finetune_step as jax_build_finetune_step
    from spcl_torch.data.creator import get_data
    from spcl_torch.training import build_finetune_step
    from test_torch_port_model import random_flax_unet
    from torch_port_helpers import jax_finetune_draws

    cfg = es.finetune_config(10, None, "unused")
    data = cfg["Data"]
    kw = dict(labeled_scan_num=data["labeled_scan_num"],
              labeled_batch_size=cfg["LabeledLoader"]["batch_size"],
              unlabeled_batch_size=cfg["UnlabeledLoader"]["batch_size"], seed=1,
              load_predefined_list=False)
    jlab = jax_get_data(tra_set=jax_load_datasets(cfg)[0], test_set=jax_load_datasets(cfg)[1],
                        **kw)[0]
    plab = get_data(tra_set=load_datasets_from_config(cfg)[0],
                    test_set=load_datasets_from_config(cfg)[1], **kw)[0]
    idx = next(iter(plab.sampler))
    assert np.array_equal(idx, next(iter(jlab.sampler)))
    jbatch = jax.tree_util.tree_map(jnp.asarray, jlab.dataset.batch(idx))
    pbatch = plab.dataset.batch(idx)
    params, stats = random_flax_unet(np.random.default_rng(3), max_channel=MAXC)
    lr = cfg["Optim"]["lr"]
    jpol = dataclasses.replace(jaug.ACDC_LABEL, crop=es.CROP)
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC)
    tx = jax_build_optimizer(name=cfg["Optim"]["name"], lr=lr)
    state = create_train_state(model_params=params, batch_stats=stats, hook_params={}, tx=tx)
    key = jax.random.PRNGKey(21)
    new_state, jm = jax_build_finetune_step(jnet, tx, num_classes=4, policy=jpol)(
        state, jbatch, key, {})

    def loss_fn(p, image):  # the step's loss (spcl_tpu/training/steps.py:163-177)
        k_aug, _ = jax.random.split(key)
        img, lab = jaug.augment_once(k_aug, image, jbatch["label"].astype(jnp.int32), jpol,
                                     sizes=jbatch["size"])
        acts, _ = jnet.apply({"params": p, "batch_stats": stats}, img, train=True,
                             mutable=["batch_stats"])
        return jax_masked_ce(acts["logits"], jax_one_hot(lab, 4), jbatch["valid"])

    grad_fn = jax.jit(jax.grad(loss_fn))
    image = jbatch["image"].astype(jnp.float32) / 255.0
    noise = jnp.asarray(np.random.default_rng(5).normal(0.0, 1e-6, image.shape), jnp.float32)
    jgrads = [unet_state_dict_from_flax(grad_fn(params, x), stats)
              for x in (image, image + noise)]
    net = UNet(input_dim=1, num_classes=4, max_channel=MAXC)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         unet_state_dict_from_flax(params, stats).items()}, strict=True)
    opt = build_optimizer(list(net.parameters()), name=cfg["Optim"]["name"], lr=lr)
    step = build_finetune_step(net, opt, num_classes=4,
                               policy=dataclasses.replace(aug.ACDC_LABEL, crop=es.CROP))
    draws = jax_finetune_draws(key, len(idx), jpol, es.CANVAS, sizes=jbatch["size"])
    pm = step(batch_to_device(pbatch, "cpu"), None, params=draws)
    return dict(jm=jm, pm=pm, net=net, new_state=new_state, lr=lr, n=len(idx),
                jgrads=jgrads[0], jgrads_noisy=jgrads[1])


def test_study_finetune_step_matches_spcl_tpu(finetune_pair):
    """Loss within 1e-4 relative and Dice counts within 2 pixels a slice and
    class (tests/test_torch_finetune.py's bounds); every parameter gradient
    under the pretrain step's rule (2e-2 where spcl_tpu's own gradient moves
    by 1e-4 or more under 1e-6 input noise, else 2e-4, and always within
    2e-4 + twice that move); each parameter after Adam's first step within lr
    x |u(g_port) - u(g_jax)| + 1e-6 of spcl_tpu's, a sign flipping only
    where |g| is below its gradient bound times the L2 norm of its gradient."""
    f = finetune_pair
    assert f["n"] == 8
    np.testing.assert_allclose(float(f["pm"]["sup_loss"]), float(f["jm"]["sup_loss"]), rtol=1e-4)
    for k in ("inter", "union"):
        np.testing.assert_allclose(f["pm"][k].numpy(), np.asarray(f["jm"][k]), rtol=0, atol=2.0)
    mu = f["new_state"].opt_state[0].mu["model"]
    want = unet_state_dict_from_flax(f["new_state"].params["model"], f["new_state"].batch_stats)
    stepped = unet_state_dict_from_flax(mu, f["new_state"].batch_stats)
    for name, p in f["net"].named_parameters():
        gp, g0 = p.grad.numpy(), f["jgrads"][name]
        moved = np.linalg.norm(f["jgrads_noisy"][name] - g0) / np.linalg.norm(g0)
        tol = 2e-2 if moved >= NOISE_MOVE_ROUTED else 2e-4
        rel = np.linalg.norm(gp - g0) / np.linalg.norm(g0)
        assert rel <= tol and rel <= 2e-4 + 2 * moved, (name, rel, moved)
        gj = stepped[name] / (1 - ADAM_B1)  # the gradient spcl_tpu's step applied
        du = f["lr"] * np.abs(_adam_direction(gp) - _adam_direction(gj))
        np.testing.assert_array_less(np.abs(p.detach().numpy() - want[name]), du + 1e-6,
                                     err_msg=name)
        flip = np.sign(gp) != np.sign(gj)
        assert np.all(np.abs(gj[flip]) <= tol * np.linalg.norm(gj)), name


# ---------------------------------------------------------------- 450 pretrain steps
def _epoch_losses(which, cfg, save_dir):
    """Each epoch's mean reg_loss of one study pretraining on the CPU, in
    spcl_tpu (`which` "jax", its own draws) or the port (its own draws)."""
    seed = cfg["RandomSeed"]
    if which == "jax":
        from spcl_tpu.entry import build_trainer as jax_build_trainer
        from spcl_tpu.utils import fix_all_seed as jax_fix_all_seed
        jax_fix_all_seed(seed)
        tr = jax_build_trainer(cfg, save_dir=save_dir, pretrain=True)
        tr.init()
        tr.start_training()
        return [next(float(v) for k, v in row.items() if "reg_loss" in k)
                for _, row in sorted(tr._storage.history.items())]
    from spcl_torch.entry import build_trainer
    from spcl_torch.utils import fix_all_seed
    fix_all_seed(seed)
    tr = build_trainer(cfg, save_dir=save_dir, pretrain=True, device="cpu")
    tr.init()
    tr.start_training()
    per_epoch = {}
    for m in tr.step_metrics:
        per_epoch.setdefault(m["epoch"], []).append(m["reg_loss"])
    return [float(np.mean(v)) for _, v in sorted(per_epoch.items())]


@pytest.mark.slow
@pytest.mark.parametrize("arm", ["plain_corrupt", "sp_clean", "sp_corrupt"])
def test_pretrain_trajectory_matches_spcl_tpu(arm, tmp_path):
    """The study's whole pretraining (15 epochs x 30 steps, seed 10) in both
    packages on the CPU, each with its own draws. In these arms the
    projection collapses (the hard gamma 3 -> 14 drops nearly every pair
    while the encoder is young; 80% corrupted positives teach nothing):
    every view maps to one z, and the loss of a batch is then a function of
    its labels and valid rows alone (log 59 with all 60 views valid). When
    it collapses varies with float rounding (spcl_tpu: epoch 3; the port's
    sp_corrupt: epoch 3 at eight torch threads, epoch 9 at one); where both
    end does not: the last three epochs' mean losses within 1e-4 relative
    of spcl_tpu's, at the fixed point. About 2 minutes an arm; tier-1 (-m
    'not slow') does not run it."""
    spec = es.ARMS[arm]["pre"]
    cfg = es.pretrain_config(10, spec["sp"], spec["corrupt"], str(tmp_path))
    want = _epoch_losses("jax", cfg, str(tmp_path / "jax"))
    got = _epoch_losses("torch", cfg, str(tmp_path / "torch"))
    assert len(got) == len(want) == es.PRE_EPOCHS
    np.testing.assert_allclose(got[-3:], want[-3:], rtol=1e-4)
    assert max(want[-3:]) <= math.log(2 * 30 - 1) + 1e-3


# ---------------------------------------------------------------- run_arm, collect, orchestrator
TINY = {"PRE_EPOCHS": 1, "PRE_BATCHES": 2, "FT_EPOCHS": 1, "FT_BATCHES": 2}


@pytest.fixture(scope="module")
def tiny_study(tmp_path_factory):
    out = tmp_path_factory.mktemp("study")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TINY.items():
            mp.setattr(es, k, v)
        recs = {arm: es.run_arm(arm, 10, device="cpu", out=out)
                for arm in ("scratch", STEP_ARM)}
    return out, recs


def _jax_record_keys():
    """The keys of the record spcl_tpu's run_arm writes (its `rec = {...}`)."""
    tree = ast.parse((ROOT / "scripts" / "effect_study.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "rec" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no rec = {...} in scripts/effect_study.py")


def test_run_arm_records(tiny_study):
    out, recs = tiny_study
    keys = _jax_record_keys()
    assert keys == {"arm", "seed", "best_val_dice", "pretrain_loss", "wall_s"}
    for arm, rec in recs.items():
        assert keys <= set(rec) and {"device", "dtype", "card"} <= set(rec)
        assert (rec["arm"], rec["seed"], rec["device"], rec["dtype"], rec["card"]) == \
            (arm, 10, "cpu", "float32", "cpu")
        assert 0.0 <= rec["best_val_dice"] <= 1.0
        assert rec["ft_ms_per_step"] > 0 and rec["wall_s"] > 0
        assert json.loads((out / f"{arm}_s10.json").read_text()) == rec
    assert recs["scratch"]["pretrain_loss"] is None
    assert "pre_ms_per_step" not in recs["scratch"]
    assert math.isfinite(recs[STEP_ARM]["pretrain_loss"])
    assert recs[STEP_ARM]["pre_ms_per_step"] > 0


def test_run_arm_checkpoints_reload_strictly(tiny_study):
    out, _ = tiny_study
    assert not (out / "scratch_s10" / "pre").exists()
    for ckpt in (out / f"{STEP_ARM}_s10" / "pre" / "last.ckpt",
                 out / f"{STEP_ARM}_s10" / "ft" / "best.ckpt",
                 out / "scratch_s10" / "ft" / "best.ckpt"):
        UNet(max_channel=MAXC).load_state_dict(load_model_state_dict(str(ckpt)), strict=True)


def test_collect_gate_and_probe_read_the_records(tiny_study, capsys):
    out, recs = tiny_study
    res = es.collect(out)
    assert set(res["rows"]) == {"scratch", STEP_ARM}
    for arm, (mean, std, n) in res["rows"].items():
        assert (mean, std, n) == (recs[arm]["best_val_dice"], 0.0, 1)
    assert set(res["gate"]) == {"scratch", STEP_ARM}
    for arm, v in res["gate"].items():
        m, s, n = es.JAX_DICE[arm]
        assert v["bound"] == round(es.GATE_SE * s / math.sqrt(n), 4)
        assert v["pass"] == (abs(recs[arm]["best_val_dice"] - m) <= es.GATE_SE * s / math.sqrt(n))
    assert "gate scratch" in capsys.readouterr().out
    summary, verdict = probe.main(["--device", "cpu", "--out", str(out)])
    assert set(summary) == {STEP_ARM} and summary[STEP_ARM]["n"] == 1
    assert 0.0 <= summary[STEP_ARM]["mean"] <= 1.0 and set(verdict) == {STEP_ARM}
    assert json.loads((out / "z_probe.json").read_text()) == summary


@pytest.mark.parametrize("sign,passes", [(1, True), (-1, True)])
def test_gate_is_three_combined_standard_errors(sign, passes):
    m, s, n = es.JAX_DICE["plain_corrupt"]
    port_std, port_n = 0.05, 4
    bound = es.GATE_SE * math.sqrt(s * s / n + port_std ** 2 / port_n)
    inside = es.gate({"plain_corrupt": (m + sign * 0.99 * bound, port_std, port_n)}, es.JAX_DICE)
    outside = es.gate({"plain_corrupt": (m + sign * 1.01 * bound, port_std, port_n),
                       "not_an_arm": (0.0, 0.0, 1)}, es.JAX_DICE)
    assert inside["plain_corrupt"]["pass"] is passes
    assert outside["plain_corrupt"]["pass"] is not passes and set(outside) == {"plain_corrupt"}


REAL_WORKER_CMD = es._worker_cmd
REAL_RUN_ARM = es.run_arm


def _fake_worker(fail):
    """A stand-in for the worker command: writes the record a run would
    (best DSC 0.1 x seed / 10), or exits 3 for the runs in `fail`."""
    def cmd(arm, seed, args):
        assert REAL_WORKER_CMD(arm, seed, args)[1:3] == ["-m", "spcl_torch.scripts.effect_study"]
        if (arm, seed) in fail:
            return [sys.executable, "-c", "raise SystemExit(3)"]
        rec = {"arm": arm, "seed": seed, "best_val_dice": 0.1 * seed / 10,
               "pretrain_loss": None, "wall_s": 0.0}
        path = Path(args.out) / f"{arm}_s{seed}.json"
        return [sys.executable, "-c",
                f"import pathlib; pathlib.Path({str(path)!r}).write_text({json.dumps(rec)!r})"]
    return cmd


def test_orchestrator_collects_and_fails_on_a_worker(tmp_path, monkeypatch):
    argv = ["--arms", "scratch,plain_corrupt", "--seeds", "10,20", "--device", "cpu",
            "--jobs", "3"]
    monkeypatch.setattr(es, "_worker_cmd", _fake_worker(set()))
    res = es.main(argv + ["--out", str(tmp_path / "ok")])
    assert res["rows"]["scratch"] == (pytest.approx(0.15), pytest.approx(0.05), 2)
    assert res["deltas"] == {}  # no paired arms among these two
    assert (tmp_path / "ok" / "plain_corrupt_s20.log").exists()
    monkeypatch.setattr(es, "_worker_cmd", _fake_worker({("plain_corrupt", 20)}))
    with pytest.raises(SystemExit, match="1 run\\(s\\) failed: plain_corrupt seed=20"):
        es.main(argv + ["--out", str(tmp_path / "bad")])
    assert (tmp_path / "bad" / "scratch_s20.json").exists()
    with pytest.raises(SystemExit, match="unknown arms"):
        es.main(["--arms", "nope", "--device", "cpu", "--out", str(tmp_path / "x")])


# ---------------------------------------------------------------- backends
def _backend_flags():
    b = torch.backends
    return (b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
            b.cuda.matmul.allow_tf32)


DETERMINISTIC = (True, False, False, False)
# corner -> (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
# cuda.matmul.allow_tf32) inside the block, written out from the table of
# spcl_torch/scripts/effect_study.py's docstring
CORNERS = {
    "deterministic": DETERMINISTIC,
    "deterministic_tf32": (True, False, True, False),
    "defaults": (False, False, True, False),
    "defaults_fp32": (False, False, False, False),
}


def test_deterministic_backends_set_the_flags_and_restore_them():
    before = _backend_flags()
    assert before != DETERMINISTIC  # PyTorch's defaults let cuDNN use TF32
    assert set(es.BACKENDS) == set(CORNERS)
    for corner, flags in CORNERS.items():
        with es.backend_corner(corner):
            assert _backend_flags() == flags, corner
        assert _backend_flags() == before
        with pytest.raises(KeyError):
            with es.backend_corner(corner):
                raise KeyError("a failed run")
        assert _backend_flags() == before
    # the block sets every flag, whatever the process had before it
    torch.backends.cudnn.benchmark = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with es.backend_corner("defaults"):
            assert _backend_flags() == CORNERS["defaults"]
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32 = before[1], before[3]
    assert _backend_flags() == before


@pytest.mark.parametrize("backends", es.BACKENDS)
def test_run_arm_trains_under_its_backends(backends, tmp_path, monkeypatch):
    seen = []

    def train(arm, seed, device, dtype, out):
        seen.append(_backend_flags())
        return {"arm": arm, "seed": seed, "best_val_dice": 0.5}

    monkeypatch.setattr(es, "_train_arm", train)
    before = _backend_flags()
    rec = es.run_arm("scratch", 10, device="cpu", out=tmp_path, backends=backends)
    assert seen == [CORNERS[backends]]
    assert _backend_flags() == before
    assert rec["backends"] == backends
    assert json.loads((tmp_path / "scratch_s10.json").read_text()) == rec


def test_backends_reach_the_workers(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(es, "run_arm", lambda *a, **k: seen.append((a, k)))
    base = ["--arm", "scratch", "--seed", "20", "--device", "cpu", "--out", str(tmp_path)]
    es.main(base + ["--backends", "defaults"])
    es.main(base + ["--backends", "deterministic_tf32"])
    es.main(base)
    assert [(a, k["backends"]) for a, k in seen] == [(("scratch", 20), "defaults"),
                                                      (("scratch", 20), "deterministic_tf32"),
                                                      (("scratch", 20), "deterministic")]
    args = es.argparse.Namespace(device="cuda", dtype="float32", backends="defaults_fp32",
                                 out=tmp_path)
    cmd = es._worker_cmd("scratch", 20, args)
    assert cmd[cmd.index("--backends") + 1] == "defaults_fp32"
    with pytest.raises(ValueError, match="backends must be one of"):
        REAL_RUN_ARM("scratch", 10, device="cpu", out=tmp_path, backends="fast")


def test_run_arm_refuses_an_unknown_corner(tmp_path, monkeypatch):
    called = []
    monkeypatch.setattr(es, "_train_arm", lambda *a: called.append(a))
    before = _backend_flags()
    for corner in ("fast", "tf32", "Deterministic", "defaults_tf32"):
        with pytest.raises(ValueError, match="backends must be one of"):
            es.run_arm("scratch", 10, device="cpu", out=tmp_path, backends=corner)
    assert called == [] and _backend_flags() == before
    assert not list(tmp_path.iterdir())
    with pytest.raises(SystemExit):
        es.main(["--arm", "scratch", "--device", "cpu", "--backends", "fast",
                 "--out", str(tmp_path)])


def _write_records(folder, arm, values):
    folder.mkdir(parents=True, exist_ok=True)
    for seed, v in values.items():
        (folder / f"{arm}_s{seed}.json").write_text(json.dumps(
            {"arm": arm, "seed": seed, "best_val_dice": v}))


def test_pair_holds_two_folders_seed_by_seed_and_by_the_gate(tmp_path, capsys):
    a = {10: 0.30, 20: 0.25, 30: 0.35, 40: 0.28}
    b = {10: 0.40, 20: 0.36, 30: 0.44, 40: 0.39, 50: 0.41}  # seed 50 unpaired
    _write_records(tmp_path / "a", "plain_clean", a)
    _write_records(tmp_path / "b", "plain_clean", b)
    _write_records(tmp_path / "a", "scratch", {10: 0.2})  # only in A: skipped
    res = es.main(["--pair", str(tmp_path / "a"), str(tmp_path / "b")])
    assert set(res) == {"plain_clean"}
    r = res["plain_clean"]
    d = np.array([b[s] - a[s] for s in (10, 20, 30, 40)])
    assert r["mean_d"] == pytest.approx(d.mean())
    assert r["se"] == pytest.approx(d.std(ddof=1) / 2.0)
    assert r["per_seed"][20] == (0.25, 0.36, pytest.approx(0.11))
    assert r["a"] == (pytest.approx(np.mean(list(a.values()))),
                      pytest.approx(np.std(list(a.values()))), 4)
    assert r["b"][2] == 5
    assert r["gate"] == es.gate({"plain_clean": r["b"]}, {"plain_clean": r["a"]})["plain_clean"]
    assert not r["gate"]["pass"]  # B lies ~0.1 above A, beyond 3 combined SEs
    out = capsys.readouterr().out
    assert "seed 20: A 0.2500 B 0.3600 d +0.1100" in out and "MISS" in out
