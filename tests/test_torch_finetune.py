"""The fine-tune / eval half of spcl_torch's main path against spcl_tpu's,
on the CPU.

- Three fine-tune steps of the whole UNet (max_channel 128, crop 32 of a
  40 canvas, batch 5, RAdam) in lockstep with
  `spcl_tpu.training.steps.build_finetune_step` under the default layout:
  transplanted weights, the same batches, the JAX step's own augmentation
  draws injected. `sup_loss` per step within 1e-4 relative; `inter` / `union`
  within 2 pixels per slice and class (an argmax tie broken the other way
  moves a pixel between classes).
- One step under `small_c_layout="pallas"` (max_channel 256, where the shapes
  are packable; spcl_tpu's side is the step's loss function spelled out, so
  that its gradients can be read): `sup_loss` within 1e-4 relative and the Conv1 / Conv2
  parameter gradients, which carry both cotangents of the fused stage (the
  pool output and the skip connection), within 2e-2 relative L2 — the bound
  tests/test_torch_port_pretrain.py states for these layers, whose gradients
  move that much in spcl_tpu itself under 1e-6 input noise.
- One eval step: loss within 1e-4 relative, Dice statistics as above.
- The pieces: `augment_once`, `center_crop`, `frame_pixel_mask`,
  `class2one_hot`, `dice_stats_from_labels`, `_masked_ce`, `UniversalDice`
  grouped by scan, `Storage`.
- `FineTuneTrainer` and `val()` end to end on synthetic data, device="cpu".
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import packing as jpacking
from spcl_tpu.losses.functional import class2one_hot as jax_one_hot
from spcl_tpu.meters.dice import UniversalDice as JaxDice
from spcl_tpu.meters.dice import dice_stats_from_labels as jax_dice_stats
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_tpu.training.steps import _masked_ce as jax_masked_ce
from spcl_tpu.training.steps import build_eval_step as jax_build_eval_step
from spcl_tpu.training.steps import build_finetune_step as jax_build_finetune_step
from spcl_torch.data import augment as aug
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.entry import build_trainer, val
from spcl_torch.losses import class2one_hot
from spcl_torch.meters import Storage, UniversalDice, dice_stats_from_labels
from spcl_torch.models import UNet, unet_state_dict_from_flax
from spcl_torch.training import (AdversarialTrainer, FineTuneTrainer, SemiTrainer,
                                 batch_to_device, build_eval_step, build_finetune_step,
                                 build_optimizer, load_checkpoint, load_model_state_dict,
                                 save_checkpoint)
from spcl_torch.training.steps import _masked_ce
from test_torch_port_model import random_flax_unet
from torch_port_helpers import jax_finetune_draws, nchw, to_torch

LR, WD = 1e-3, 1e-5
CANVAS, CROP, B = 40, 32, 5


def _pair(max_channel, layout, seed):
    """(flax net, params, stats, port net) from the same random weights."""
    params, stats = random_flax_unet(np.random.default_rng(seed), max_channel=max_channel)
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=max_channel,
                   small_c_layout=layout)
    net = UNet(input_dim=1, num_classes=4, max_channel=max_channel, small_c_layout=layout)
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in unet_state_dict_from_flax(params, stats).items()},
                        strict=True)
    return jnet, params, stats, net


def _batches(k):
    """k labeled batches of B slices, the same indices from both packages'
    synthetic datasets."""
    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    pds = synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    rng = np.random.default_rng(11)
    idx = [rng.choice(len(pds.images), B, replace=False) for _ in range(k)]
    return [(jds.batch(i), pds.batch(i)) for i in idx]


def _lockstep(max_channel, layout, steps, seed, with_grads=False):
    jnet, params, stats, net = _pair(max_channel, layout, seed)
    jpol = dataclasses.replace(jaug.ACDC_LABEL, crop=CROP)
    ppol = dataclasses.replace(aug.ACDC_LABEL, crop=CROP)
    tx = jax_build_optimizer(name="RAdam", lr=LR, weight_decay=WD)
    state = create_train_state(model_params=params, batch_stats=stats, hook_params={}, tx=tx)
    jstep = jax_build_finetune_step(jnet, tx, num_classes=4, policy=jpol)
    opt = build_optimizer(list(net.parameters()), lr=LR, weight_decay=WD)
    step = build_finetune_step(net, opt, num_classes=4, policy=ppol)
    keys = jax.random.split(jax.random.PRNGKey(7), steps)
    records, jgrads, jstats = [], None, None
    for key, (jbatch, pbatch) in zip(keys, _batches(steps)):
        jb = jax.tree_util.tree_map(jnp.asarray, jbatch)
        draws = jax_finetune_draws(key, B, jpol, CANVAS, sizes=jb["size"])
        if with_grads:
            # the step's loss (spcl_tpu/training/steps.py:163-177, 204-205) spelled
            # out, so that its gradients can be read: one compile instead of two
            def loss_fn(p):
                k_aug, _ = jax.random.split(key)
                img, lab = jaug.augment_once(k_aug, jb["image"].astype(jnp.float32) / 255.0,
                                             jb["label"].astype(jnp.int32), jpol,
                                             sizes=jb["size"])
                acts, mut = jnet.apply({"params": p, "batch_stats": stats}, img, train=True,
                                       mutable=["batch_stats"])
                sup = jax_masked_ce(acts["logits"], jax_one_hot(lab, 4), jb["valid"])
                inter, union = jax_dice_stats(jnp.argmax(acts["logits"], axis=-1), lab, 4,
                                              jb["valid"])
                return sup, (mut["batch_stats"], inter, union)

            (sup, (jstats, inter, union)), jgrads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(state.params["model"])
            jm = {"sup_loss": sup, "inter": inter, "union": union}
        else:
            state, jm = jstep(state, jb, key, {})
            jstats = state.batch_stats
        pm = step(batch_to_device(pbatch, "cpu"), None, params=draws)
        records.append((jm, pm))
    return dict(records=records, stats=jstats, net=net, jgrads=jgrads)


def _close_counts(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2.0, err_msg=what)


@pytest.fixture(scope="module")
def nhwc_run():
    return _lockstep(128, "nhwc", 3, seed=0)


@pytest.fixture(scope="module")
def pallas_run():
    return _lockstep(256, "pallas", 1, seed=1, with_grads=True)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_finetune_steps_track_spcl_tpu(nhwc_run, k):
    jm, pm = nhwc_run["records"][k]
    np.testing.assert_allclose(float(pm["sup_loss"]), float(jm["sup_loss"]), rtol=1e-4)
    _close_counts(pm["inter"], jm["inter"], "inter")
    _close_counts(pm["union"], jm["union"], "union")
    assert pm["inter"].shape == (B, 4)


def test_finetune_running_statistics_track_spcl_tpu(nhwc_run):
    stats = nhwc_run["stats"]
    for stage in ("Conv1", "Conv5", "Up_conv2"):
        bn = nhwc_run["net"].stage(stage).conv[1]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats[stage]["bn0"]["mean"]), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats[stage]["bn0"]["var"]), rtol=1e-3, atol=1e-4)


def test_finetune_step_under_pallas_tracks_spcl_tpu(pallas_run):
    jm, pm = pallas_run["records"][0]
    np.testing.assert_allclose(float(pm["sup_loss"]), float(jm["sup_loss"]), rtol=1e-4)
    _close_counts(pm["inter"], jm["inter"], "inter")
    _close_counts(pm["union"], jm["union"], "union")


@pytest.mark.parametrize("stage", ["Conv1", "Conv2"])
def test_fused_stage_parameter_gradients_track_spcl_tpu(pallas_run, stage):
    block = pallas_run["net"].stage(stage).conv
    jg = pallas_run["jgrads"][stage]
    pairs = [(block[0].weight, np.transpose(np.asarray(jg["conv0"]["kernel"]), (3, 2, 0, 1))),
             (block[3].weight, np.transpose(np.asarray(jg["conv1"]["kernel"]), (3, 2, 0, 1))),
             (block[1].weight, np.asarray(jg["bn0"]["scale"])),
             (block[1].bias, np.asarray(jg["bn0"]["bias"])),
             (block[4].weight, np.asarray(jg["bn1"]["scale"])),
             (block[4].bias, np.asarray(jg["bn1"]["bias"]))]
    for t, want in pairs:
        assert t.grad is not None and np.linalg.norm(want) > 0
        rel = np.linalg.norm(t.grad.numpy() - want) / np.linalg.norm(want)
        assert rel <= 2e-2, (stage, tuple(t.shape), rel)


def test_fused_stage_running_statistics_after_the_step(pallas_run):
    stats = pallas_run["stats"]
    for stage in ("Conv1", "Conv2"):
        block = pallas_run["net"].stage(stage).conv
        for i, bn in enumerate((block[1], block[4])):
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(stats[stage][f"bn{i}"]["var"]),
                                       rtol=1e-4, atol=1e-5)
            assert int(bn.num_batches_tracked) == 1


def test_eval_step_matches_spcl_tpu():
    jnet, params, stats, net = _pair(128, "nhwc", seed=2)
    jbatch, pbatch = _batches(1)[0]
    jbatch["valid"][-1] = 0.0
    pbatch["valid"][-1] = 0.0
    jout = jax_build_eval_step(jnet, num_classes=4, crop=CROP)(
        params, stats, jax.tree_util.tree_map(jnp.asarray, jbatch))
    net.train()  # the step itself switches to eval mode
    out = build_eval_step(net, num_classes=4, crop=CROP)(batch_to_device(pbatch, "cpu"))
    assert not net.training
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-4)
    _close_counts(out["inter"], jout["inter"], "inter")
    _close_counts(out["union"], jout["union"], "union")
    assert float(out["union"][-1].sum()) == 0.0  # padded slice


# ------------------------------------------------------------------ the pieces
def test_augment_once_matches_spcl_tpu():
    jbatch, pbatch = _batches(1)[0]
    key = jax.random.PRNGKey(3)
    for policy_name in ("ACDC_LABEL", "ACDC_PRETRAIN"):  # without and with jitter
        jpol = dataclasses.replace(getattr(jaug, policy_name), crop=CROP)
        ppol = dataclasses.replace(getattr(aug, policy_name), crop=CROP)
        k_aug, _ = jax.random.split(key)
        jimg, jlab = jaug.augment_once(k_aug, jnp.asarray(jbatch["image"], jnp.float32) / 255.0,
                                       jnp.asarray(jbatch["label"], jnp.int32), jpol,
                                       sizes=jnp.asarray(jbatch["size"]))
        draws = jax_finetune_draws(key, B, jpol, CANVAS, sizes=jnp.asarray(jbatch["size"]))
        img, lab = aug.augment_once(torch.from_numpy(pbatch["image"]).float() / 255.0,
                                    torch.from_numpy(pbatch["label"]).long(), ppol,
                                    draws["aug"])
        np.testing.assert_allclose(img.numpy(), nchw(jimg), rtol=0, atol=1e-5)
        assert np.array_equal(lab.numpy(), np.asarray(jlab))


@pytest.mark.parametrize("policy_name,out_size", [("ACDC_VAL", None), ("PROSTATE_VAL", 48),
                                                  ("SPLEEN_VAL", None)])
def test_center_crop_and_frame_mask_match_spcl_tpu(policy_name, out_size):
    rng = np.random.default_rng(5)
    image = rng.random((3, CANVAS, CANVAS, 1)).astype(np.float32)
    label = rng.integers(0, 4, (3, CANVAS, CANVAS)).astype(np.int32)
    sizes = np.array([[40, 40], [30, 40], [36, 24]], np.int32)
    jpol = dataclasses.replace(getattr(jaug, policy_name), crop=CROP,
                               resize={"ACDC_VAL": None, "PROSTATE_VAL": CROP,
                                       "SPLEEN_VAL": (CROP, CROP)}[policy_name])
    ppol = dataclasses.replace(getattr(aug, policy_name), crop=CROP, resize=jpol.resize)
    jimg, jlab = jaug.center_crop(jnp.asarray(image), jnp.asarray(label), CROP,
                                  jnp.asarray(sizes), jpol, out_size)
    img, lab = aug.center_crop(torch.from_numpy(nchw(image).copy()),
                               torch.from_numpy(label).long(), CROP,
                               torch.from_numpy(sizes), ppol, out_size)
    np.testing.assert_allclose(img.numpy(), nchw(jimg), rtol=0, atol=1e-5)
    assert np.array_equal(lab.numpy(), np.asarray(jlab))
    out = CROP if out_size is None else out_size
    jgeo = jaug.center_geometric(3, jpol, CANVAS, jnp.asarray(sizes), out)
    geo = aug.center_geometric(3, ppol, CANVAS, torch.from_numpy(sizes), out)
    for k in jgeo:
        np.testing.assert_allclose(geo[k].numpy(), np.asarray(jgeo[k]), err_msg=k)
    assert np.array_equal(aug.frame_pixel_mask(geo, out).numpy(),
                          np.asarray(jaug.frame_pixel_mask(jgeo, out)))


def test_one_hot_dice_stats_and_masked_ce_match_spcl_tpu():
    rng = np.random.default_rng(6)
    pred = rng.integers(0, 4, (3, 8, 8))
    lab = rng.integers(0, 4, (3, 8, 8))
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    mask = (rng.random((3, 8, 8)) > 0.3).astype(np.float32)
    logits = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    onehot = class2one_hot(torch.from_numpy(lab), 4)
    assert onehot.shape == (3, 4, 8, 8)
    assert np.array_equal(onehot.numpy(), nchw(jax_one_hot(jnp.asarray(lab), 4)))
    for pm in (None, mask):
        ji, ju = jax_dice_stats(jnp.asarray(pred), jnp.asarray(lab), 4, jnp.asarray(valid),
                                None if pm is None else jnp.asarray(pm))
        pi, pu = dice_stats_from_labels(torch.from_numpy(pred), torch.from_numpy(lab), 4,
                                        torch.from_numpy(valid),
                                        None if pm is None else torch.from_numpy(pm))
        assert np.array_equal(pi.numpy(), np.asarray(ji))
        assert np.array_equal(pu.numpy(), np.asarray(ju))
        want = jax_masked_ce(jnp.asarray(logits), jax_one_hot(jnp.asarray(lab), 4),
                             jnp.asarray(valid), None if pm is None else jnp.asarray(pm))
        got = _masked_ce(torch.from_numpy(nchw(logits).copy()), onehot,
                         torch.from_numpy(valid), None if pm is None else torch.from_numpy(pm))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("grouping", ["by_scan", "one_scan", "per_slice"])
def test_universal_dice_matches_spcl_tpu(grouping):
    rng = np.random.default_rng(8)
    jd = JaxDice(4, report_axises=[1, 2, 3])
    pd_ = UniversalDice(4, report_axises=[1, 2, 3])
    for b in range(3):
        pred = rng.integers(0, 4, (6, 10, 10))
        lab = rng.integers(0, 4, (6, 10, 10))
        group = {"by_scan": [f"scan{(b + i) % 4}" for i in range(6)], "one_scan": f"scan{b}",
                 "per_slice": None}[grouping]
        valid = np.array([1, 1, 1, 0, 1, 1], np.float32) if grouping == "by_scan" else None
        jd.add_labels(pred, lab, group_name=group, valid=valid)
        pd_.add_labels(pred, lab, group_name=group, valid=valid)
    want, got = jd.summary(), pd_.summary()
    assert sorted(got) == sorted(want) == ["DSC1", "DSC2", "DSC3", "DSC_mean"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert pd_.group_names == jd.group_names
    empty = UniversalDice(4)
    assert np.isnan(empty.value()[0]).all()


def test_storage_writes_one_row_per_epoch(tmp_path):
    st = Storage(save_dir=str(tmp_path))
    st.put_epoch(1, {"tra": {"sup_loss": {"mean": 1.5}}, "val": {"dice": {"DSC_mean": 0.25}}})
    st.put_epoch(2, {"tra": {"sup_loss": {"mean": 1.0}}, "val": {"dice": {"DSC_mean": 0.5}},
                     "test": {"loss": {"mean": 2.0}}})
    st.flush()
    rows = list(csv.DictReader(open(tmp_path / "storage.csv")))
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert float(rows[1]["val/dice/DSC_mean"]) == 0.5
    assert rows[0]["test/loss/mean"] == "" and float(rows[1]["test/loss/mean"]) == 2.0
    other = Storage()
    other.load_state_dict(st.state_dict())
    assert other.history == st.history


# ------------------------------------------------------------------ trainer and sweep
def _ft_config(tmp_path, layout="nhwc", max_channel=128):
    return {
        "RandomSeed": 10,
        "Arch": {"input_dim": 1, "num_classes": 4, "max_channel": max_channel,
                 "momentum": 0.1, "small_c_layout": layout},
        "Optim": {"name": "RAdam", "lr": 1e-4, "weight_decay": 1e-5},
        "Scheduler": {"multiplier": 400, "warmup_max": 10},
        "Data": {"name": "acdc", "labeled_scan_num": 2, "canvas": 48, "crop": 32,
                 "synthetic": True, "synthetic_scans": 6, "synthetic_test_scans": 6},
        "LabeledLoader": {"batch_size": 4},
        "Trainer": {"num_batches": 2, "max_epoch": 2, "save_every": 1, "name": "ft",
                    "save_dir": str(tmp_path)},
    }


def test_finetune_trainer_runs_on_cpu(tmp_path):
    pre = tmp_path / "pre.ckpt"
    torch.manual_seed(0)
    warm = UNet(max_channel=128)
    save_checkpoint(str(pre), {"_model": warm.state_dict()})
    config = _ft_config(tmp_path)
    config["Arch"]["checkpoint"] = str(pre)
    trainer = build_trainer(config, save_dir=str(tmp_path / "run"), device="cpu")
    assert isinstance(trainer, FineTuneTrainer) and trainer.hooks == []
    trainer.init()
    assert torch.equal(trainer.model._Conv3.conv[0].weight, warm._Conv3.conv[0].weight)
    assert all(p.requires_grad for p in trainer.model.parameters())
    best = trainer.start_training()
    assert 0.0 <= best <= 1.0 and best == trainer.best_score
    assert len(trainer.step_metrics) == 4
    assert all(np.isfinite(r["sup_loss"]) for r in trainer.step_metrics)
    run = tmp_path / "run"
    assert (run / ".success").exists()
    rows = list(csv.DictReader(open(run / "storage.csv")))
    assert len(rows) == 2 and 0.0 <= float(rows[-1]["val/dice/DSC_mean"]) <= 1.0
    assert "test/dice/DSC_mean" in rows[0] and "tra/sup_dice/DSC_mean" in rows[0]
    fresh = UNet(max_channel=128)
    fresh.load_state_dict(load_model_state_dict(str(run / "best.ckpt")), strict=True)
    last = load_checkpoint(str(run / "last.ckpt"))
    assert last["cur_epoch"] == 2 and last["best_score"] == best
    # the semi and adversarial trainers are ported (the latter is a semi loop)
    semi = build_trainer({**config, "Trainer": {**config["Trainer"], "name": "semi"}},
                         device="cpu")
    assert isinstance(semi, SemiTrainer)
    adv = build_trainer({**config, "Trainer": {**config["Trainer"], "name": "adv"}},
                        device="cpu")
    assert isinstance(adv, AdversarialTrainer)


@pytest.mark.parametrize("layout,max_channel", [("nhwc", 128), ("pallas", 256)])
def test_val_sweep_end_to_end(tmp_path, layout, max_channel):
    """`val()` for one ratio, 1 epoch x 2 steps, from a pretrained checkpoint
    written under the default layout (checkpoints do not depend on it)."""
    pre = tmp_path / "pre" / "last.ckpt"
    save_checkpoint(str(pre), {"_model": UNet(max_channel=max_channel).state_dict()})
    config = _ft_config(tmp_path, layout, max_channel)
    config["Trainer"].update(max_epoch=1)
    del config["Trainer"]["name"]
    scores = val(base_config=config, pretrained_checkpoint=str(pre), save_dir=str(tmp_path),
                 labeled_ratios=[2], device="cpu")
    assert list(scores) == [2] and 0.0 <= scores[2] <= 1.0
    best = load_checkpoint(str(tmp_path / "tra_2" / "best.ckpt"))
    plain = UNet(max_channel=max_channel)  # a pallas run reloads into a plain UNet
    plain.load_state_dict(best["_model"], strict=True)
