"""The spcl_torch pretrain slice as a whole, on the CPU.

- One whole pretrain step against spcl_tpu's: transplanted weights, the
  JAX step's own augmentation and flip draws injected, the same batch.
  Compared: the loss, sp_weight, every parameter gradient (UNet encoder and
  projection head) and the parameters after one RAdam step. Tolerance: the
  loss and sp_weight rtol 1e-4; gradients of Conv4, Conv5 and the head
  relative L2 error 2e-4; gradients of Conv1-Conv3 relative L2 error 2e-2:
  float32 rounding differences of 1e-5 in the forward flip a few ReLU and
  max-pool routing decisions, and these layers' gradients are that
  sensitive — spcl_tpu's own Conv1 kernel gradient moves by 2e-2 (relative
  L2) when its input gets 1e-6 noise, while Conv4/Conv5 move by 4e-5.
  Updated parameters atol 1e-6 (lr 1e-3).
- The trainer for 1 epoch x 2 batches at small width with device="cpu",
  and the `python -m spcl_torch.main_pretrain_encoder` entry point.
- The import rule: no module of spcl_torch, nor chip_smoke.py, imports jax,
  flax, optax or spcl_tpu (AST scan), and importing every spcl_torch module
  in a fresh interpreter loads none of them.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import packing as jpacking
from spcl_tpu.data.creator import create_contrastive_loader as jax_contrastive_loader
from spcl_tpu.hooks.infonce import SelfPacedINFONCEHook as JaxSPHook
from spcl_tpu.models.masking import stage_trainable_mask
from spcl_tpu.models.torch_import import flax_from_torch_state_dict
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_tpu.training.steps import build_pretrain_step as jax_build_pretrain_step
from spcl_torch.data import augment as aug
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.data.creator import create_contrastive_loader
from spcl_torch.hooks import SelfPacedINFONCEHook
from spcl_torch.models import (UNet, head_state_dict_from_flax, set_trainable_stages,
                               stages_from_range, unet_state_dict_from_flax)
from spcl_torch.training import batch_to_device, build_optimizer, build_pretrain_step
from torch_port_helpers import jax_step_draws

ROOT = Path(__file__).resolve().parents[1]
MAXC = 128
ENCODER = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
FORBIDDEN = ("jax", "flax", "optax", "spcl_tpu")


def _random_encoder(rng):
    """flax encoder variables (Conv1..Conv5) drawn with numpy."""
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
    params, stats = flax_from_torch_state_dict(sd)
    return ({k: params[k] for k in ENCODER}, {k: stats[k] for k in ENCODER})


def _random_head(rng, c_in):
    def dense(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": rng.normal(0.0, 0.1, (o,)).astype(np.float32)}
    return {"params": {"fc0": dense(c_in, 256), "fc1": dense(256, 256)}}


def run_step_pair():
    """One step of each package from the same weights, batch and draws."""
    rng = np.random.default_rng(0)
    params, stats = _random_encoder(rng)
    head = _random_head(rng, MAXC)
    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=40, seed=0)
    jbatch = next(iter(jax_contrastive_loader(jds, scan_sample_num=2, seed=3)))
    pds = synthetic_dataset("acdc", num_scans=4, canvas=40, seed=0)
    pbatch = next(iter(create_contrastive_loader(pds, scan_sample_num=2, seed=3)))
    n = jbatch["image"].shape[0]
    gamma, lr, wd = 3.0, 1e-3, 1e-5
    key = jax.random.PRNGKey(42)

    # ---- spcl_tpu
    jpol = dataclasses.replace(jaug.ACDC_PRETRAIN, crop=32)
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC)
    jhook = JaxSPHook(name="sp", feature_name="Conv5", weight=0.1, mode="hard",
                      begin_value=3, end_value=14, max_epoch=2)
    tx = jax_build_optimizer(name="RAdam", lr=lr, weight_decay=wd)
    mask = stage_trainable_mask(params, stages_from_range(None, "Conv5"))
    state = create_train_state(model_params=params, batch_stats=stats,
                               hook_params={"sp": head}, tx=tx)
    jbatch_dev = jax.tree_util.tree_map(jnp.asarray, jbatch)
    scalars = {"sp": {"gamma": jnp.float32(gamma)}}

    def loss_fn(p):  # spcl_tpu/training/steps.py:420-445, spelled out for grads
        k_aug, k_flip, k_hooks = jax.random.split(key, 3)
        image = jbatch_dev["image"].astype(jnp.float32) / 255.0
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
        loss, m = jhook.loss_fn(p["hooks"]["sp"], ctx, scalars["sp"])
        return loss, m

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    jstep = jax_build_pretrain_step(jnet, [jhook], tx, policy=jpol, total_freedom=True,
                                    until="Conv5", grad_mask=mask)
    new_state, jmetrics = jstep(state, jbatch_dev, key, scalars)

    # ---- spcl_torch
    net = UNet(input_dim=1, num_classes=4, max_channel=MAXC)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         unet_state_dict_from_flax(params, stats, allow_partial=True).items()},
                        strict=False)
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv5", weight=0.1, mode="hard",
                                begin_value=3, end_value=14, max_epoch=2)
    hook.build(net, "cpu")
    hook.projector.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in head_state_dict_from_flax(head).items()})
    ps = [p for p in net.parameters() if p.requires_grad] + hook.parameters()
    opt = build_optimizer(ps, lr=lr, weight_decay=wd)
    ppol = dataclasses.replace(aug.ACDC_PRETRAIN, crop=32)
    step = build_pretrain_step(net, [hook], opt, policy=ppol, total_freedom=True,
                               until="Conv5")
    draws = jax_step_draws(key, n, jpol, 40, sizes=jbatch_dev["size"])
    metrics = step(batch_to_device(pbatch, "cpu"), None, {"sp": {"gamma": gamma}},
                   params=draws)
    return dict(jloss=float(jloss), jm=jm, jgrads=jgrads, new_state=new_state,
                jmetrics=jmetrics, metrics=metrics, net=net, hook=hook)


@pytest.fixture(scope="module")
def step_pair():
    return run_step_pair()


def _port_tensors(net, hook):
    """{(scope, flax path): (torch tensor of the port, flax->torch layout fn)}"""
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
        out[("hooks", "sp", "params", fc, "kernel")] = (layer.weight, lambda w: w.T)
        out[("hooks", "sp", "params", fc, "bias")] = (layer.bias, lambda w: w)
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def test_step_loss_and_sp_weight_match(step_pair):
    s = step_pair
    np.testing.assert_allclose(float(s["metrics"]["reg_loss"]), s["jloss"], rtol=1e-4)
    np.testing.assert_allclose(float(s["jmetrics"]["reg_loss"]), s["jloss"], rtol=1e-6)
    np.testing.assert_allclose(float(s["metrics"]["hooks"]["sp"]["sp_weight"]),
                               float(s["jm"]["sp_weight"]), rtol=1e-4)
    assert s["metrics"]["hooks"]["sp"]["age_param"] == 3.0


def test_step_every_gradient_matches(step_pair):
    s = step_pair
    tensors = _port_tensors(s["net"], s["hook"])
    assert len(tensors) == 5 * 6 + 4  # every encoder and head parameter
    for path, (t, layout) in tensors.items():
        want = layout(_get(s["jgrads"], path))
        got = t.grad.numpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        tol = 2e-2 if path[1] in ("Conv1", "Conv2", "Conv3") else 2e-4
        assert rel <= tol, (path, rel)


def test_step_updated_parameters_match(step_pair):
    s = step_pair
    for path, (t, layout) in _port_tensors(s["net"], s["hook"]).items():
        want = layout(_get(s["new_state"].params, path))
        np.testing.assert_allclose(t.detach().numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=str(path))


def test_decoder_takes_no_update(step_pair):
    for name in ("Up5", "Up_conv5", "Up2", "Up_conv2", "Deconv_1x1"):
        for p in step_pair["net"].stage(name).parameters():
            assert p.grad is None and not p.requires_grad


def _small_config(tmp_path):
    return {
        "RandomSeed": 10,
        "Arch": {"input_dim": 1, "num_classes": 4, "max_channel": MAXC, "momentum": 0.1},
        "Optim": {"name": "RAdam", "lr": 1e-7, "weight_decay": 1e-5},
        "Scheduler": {"multiplier": 400, "warmup_max": 10},
        "Data": {"name": "acdc", "labeled_scan_num": 1, "canvas": 48, "crop": 32,
                 "synthetic": True, "synthetic_scans": 6, "synthetic_test_scans": 3},
        "Trainer": {"num_batches": 2, "max_epoch": 1, "save_every": 1,
                    "name": "pretrain_encoder", "save_dir": str(tmp_path)},
        "ContrastiveLoaderParams": {"scan_sample_num": 2, "partition_sample_num": 1},
        "SPInfonceParams": {"feature_names": "Conv5", "weights": 0.1,
                            "contrast_ons": "partition", "temperature": 0.07,
                            "begin_values": 3, "end_values": 14, "p": 0.5, "mode": "hard"},
    }


def test_trainer_runs_on_cpu(tmp_path):
    from spcl_torch.entry import build_trainer
    from spcl_torch.training import load_model_state_dict

    trainer = build_trainer(_small_config(tmp_path), save_dir=str(tmp_path), pretrain=True,
                            device="cpu")
    assert trainer._forward_until == "Conv5"
    trainer.init()
    trainer.start_training()
    assert len(trainer.step_metrics) == 2
    for rec in trainer.step_metrics:
        assert np.isfinite(rec["reg_loss"])
        hm = rec["hooks"]["spinfonce/Conv5/partition"]
        assert 0.0 <= hm["sp_weight"] <= 1.0
        assert hm["age_param"] == 3.0
    fresh = UNet(max_channel=MAXC)
    fresh.load_state_dict(load_model_state_dict(str(tmp_path / "last.ckpt")), strict=True)
    assert (tmp_path / ".success").exists()


def test_main_pretrain_encoder_entry_point(tmp_path):
    from spcl_torch.main_pretrain_encoder import main

    ckpt = main(["Arch.max_channel=128", "Data.synthetic=true", "Data.canvas=48",
                 "Data.crop=32", "Data.synthetic_scans=6", "Trainer.num_batches=1",
                 "Trainer.max_epoch=1", f"Trainer.save_dir={tmp_path}",
                 "ContrastiveLoaderParams.scan_sample_num=2", "--opt-path",
                 str(ROOT / "config" / "specific" / "selfpaced_infonce.yaml")],
                device="cpu")
    assert Path(ckpt).exists()


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_ast():
    files = sorted((ROOT / "spcl_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    for f in files:
        bad = set(_imported_roots(f)) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_port_imports_no_jax_at_run_time():
    code = ("import importlib, pkgutil, sys, spcl_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(spcl_torch.__path__, 'spcl_torch.')]\n"
            "[importlib.import_module(m) for m in mods]\n"
            f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 40
