"""The semi-supervised and mixup trainers of spcl_torch end to end on the
CPU, the legacy preset names, and resume from a checkpoint.

- `SemiTrainer` (mean teacher + consistency) and `MixUpTrainer` run through
  `build_trainer` with device="cpu" at small width (UNet-128, crop 32 of a
  40 canvas, 2 epochs x 2 steps): finite losses, every hook's metrics, Dice
  in [0, 1], storage.csv, best/last checkpoints that reload strictly.
- Each of the 11 names of `LEGACY_TRAINER_PRESETS` builds a `SemiTrainer`
  with the hooks of spcl_tpu's `build_trainer` for the same config: the same
  classes in the same order, with the same settings (name, weight, feature
  stage, padding, alpha, ...).
- Resume: a run of 2 epochs, and a run that resumes from the first run's
  epoch-1 `last.ckpt` and trains epoch 2, end equal to the bit — the
  student, the EMA teacher and its step count, the optimizer state, the
  projector of a discrete-MI hook, UC-MT's threshold schedule, the best
  score, the storage and epoch 2's step metrics (the step generator's and
  the samplers' states ride in the checkpoint).
- `python -m spcl_torch.main ... --device cpu trainer_checkpoint=...` runs
  epoch 2 only, and so does `python -m spcl_torch.main_mixup`.
- `Trainer.device_data` true (the store) and false (host batches through
  `device_prefetch`) train the semi trainer to the same bits.
- `chip_smoke.py`'s transcribed config files equal the YAML files.
"""
import csv
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spcl_torch.entry import build_trainer
from spcl_torch.hooks import LEGACY_TRAINER_PRESETS
from spcl_torch.models import UNet
from spcl_torch.training import (MixUpTrainer, SemiTrainer, load_checkpoint,
                                 load_model_state_dict)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["Data.synthetic=true", "Data.canvas=40", "Data.crop=32", "Arch.max_channel=128",
         "Data.synthetic_scans=4", "Data.synthetic_test_scans=4", "Trainer.num_batches=2",
         "LabeledLoader.batch_size=3", "UnlabeledLoader.batch_size=3", "Optim.lr=1e-4"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its CPU ops are small, and the
    suite runs test files side by side in several processes, where spinning
    intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp_path, name="semi", max_epoch=2, **blocks):
    config = {
        "RandomSeed": 3,
        "Arch": {"max_channel": 128, "small_c_layout": "nhwc"},
        "Optim": {"name": "RAdam", "lr": 1e-4, "weight_decay": 1e-5},
        "Scheduler": {"multiplier": 300, "warmup_max": 10},
        "Data": {"name": "acdc", "labeled_scan_num": 1, "canvas": 40, "crop": 32,
                 "synthetic": True, "synthetic_scans": 4, "synthetic_test_scans": 4},
        "LabeledLoader": {"batch_size": 3}, "UnlabeledLoader": {"batch_size": 3},
        "Trainer": {"name": name, "num_batches": 2, "max_epoch": max_epoch,
                    "save_dir": str(tmp_path)},
    }
    config.update(blocks)
    return config


MT_UDA = {"MeanTeacherParams": {"weight": 10.0, "alpha": 0.999},
          "ConsistencyParams": {"weight": 5.0}}


def _check_run(trainer, run: Path, hooks, reg=True):
    best = trainer.start_training()
    assert 0.0 <= best <= 1.0
    assert len(trainer.step_metrics) == 4
    for rec in trainer.step_metrics:
        assert np.isfinite(rec["sup_loss"]) and (not reg or np.isfinite(rec["reg_loss"]))
        assert sorted(rec["hooks"]) == sorted(hooks)
        assert all(np.isfinite(v) for m in rec["hooks"].values() for v in m.values())
    rows = list(csv.DictReader(open(run / "storage.csv")))
    assert len(rows) == 2 and 0.0 <= float(rows[-1]["val/dice/DSC_mean"]) <= 1.0
    for h in hooks:
        assert any(k.startswith(h + "/") for k in rows[0]), h
    fresh = UNet(max_channel=128)
    fresh.load_state_dict(load_model_state_dict(str(run / "best.ckpt")), strict=True)
    assert (run / ".success").exists()
    return load_checkpoint(str(run / "last.ckpt"))


def test_semi_trainer_runs_on_cpu(tmp_path):
    trainer = build_trainer(_config(tmp_path, **MT_UDA), device="cpu")
    assert isinstance(trainer, SemiTrainer)
    trainer.init()
    assert trainer.teacher is not None and trainer.teacher.alpha_max == 0.999
    last = _check_run(trainer, tmp_path, ["mt", "consistency"])
    assert last["_teacher"]["step"] == 4 and last["cur_epoch"] == 2
    UNet(max_channel=128).load_state_dict(last["_teacher"]["model"], strict=True)


def test_mixup_trainer_runs_on_cpu(tmp_path):
    trainer = build_trainer(_config(tmp_path, name="mixup",
                                    MixUpParams={"weight": 0.5, "enable_bn": True}),
                            device="cpu")
    assert isinstance(trainer, MixUpTrainer) and trainer.teacher is None
    trainer.init()
    _check_run(trainer, tmp_path, ["mix_reg"], reg=False)


CORE = ("name", "weight", "feature_name", "contrast_on", "padding", "patch_size", "alpha",
        "num_noise_samples", "noise_std", "temperature", "enable_bn")


def _settings(h):
    return {k: v for k, v in vars(h).items()
            if isinstance(v, (str, int, float, bool, type(None))) and not k.startswith("_")}


@pytest.mark.parametrize("preset", sorted(LEGACY_TRAINER_PRESETS))
def test_legacy_preset_builds_spcl_tpus_hooks(tmp_path, preset):
    from spcl_tpu.entry import build_trainer as jax_build_trainer
    from spcl_tpu.hooks.creator import LEGACY_TRAINER_PRESETS as JAX_PRESETS
    assert LEGACY_TRAINER_PRESETS[preset] == JAX_PRESETS[preset]
    config = _config(tmp_path, name=preset)
    trainer = build_trainer(config, save_dir=str(tmp_path / "port"), device="cpu")
    jtrainer = jax_build_trainer(config, save_dir=str(tmp_path / "jax"))
    assert isinstance(trainer, SemiTrainer) and type(jtrainer).__name__ == "SemiTrainer"
    assert [type(h).__name__ for h in trainer.hooks] == [type(h).__name__
                                                         for h in jtrainer._hooks]
    for h, jh in zip(trainer.hooks, jtrainer._hooks):
        mine, theirs = _settings(h), _settings(jh)
        # the settings that decide the loss are held by both; the settings
        # both hold agree (spcl_tpu's infonce hook also keeps decoder-stage
        # settings, which the port's encoder-only hook has no use for)
        assert {"name", "weight"} <= set(mine)
        assert set(CORE) & set(theirs) <= set(mine), h.name
        shared = set(mine) & set(theirs)
        assert {k: mine[k] for k in shared} == {k: theirs[k] for k in shared}, h.name


def _resume_config(tmp_path):
    return _config(tmp_path, **MT_UDA,
                   UCMeanTeacherParams={"weight": 1.0, "threshold_begin": 0.5,
                                        "threshold_end": 0.9},
                   DiscreteMIConsistencyParams={"feature_names": ["Conv5"],
                                                "mi_weights": 0.1, "consistency_weight": 0.0})


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_resume_equals_an_uninterrupted_run(tmp_path):
    full = build_trainer(_resume_config(tmp_path / "full"), device="cpu")
    full.init()
    save_to = full.save_to

    def keep_each_epoch(name):  # the last.ckpt of every epoch, kept
        save_to(name)
        if name == "last.ckpt":
            shutil.copy(tmp_path / "full" / name, tmp_path / f"epoch{full._cur_epoch}.ckpt")

    full.save_to = keep_each_epoch
    full.start_training()

    resumed = build_trainer(_resume_config(tmp_path / "resumed"), device="cpu")
    resumed.init()
    resumed.resume_from_path(str(tmp_path / "epoch1.ckpt"))
    assert resumed._cur_epoch == 1
    resumed.start_training()
    assert [r["epoch"] for r in resumed.step_metrics] == [2, 2]
    assert resumed.step_metrics == full.step_metrics[2:]
    a = load_checkpoint(str(tmp_path / "full" / "last.ckpt"))
    b = load_checkpoint(str(tmp_path / "resumed" / "last.ckpt"))
    for key in ("_model", "_optimizer", "_teacher", "_hooks", "_hook_states", "_generator",
                "_samplers", "cur_epoch", "best_score"):
        _assert_same(a[key], b[key], key)
    # the storage rows too, but for the measured throughput
    for hist in (a["storage"]["history"], b["storage"]["history"]):
        for row in hist.values():
            for k in [k for k in row if "throughput" in k]:
                del row[k]
    _assert_same(a["storage"], b["storage"], "storage")
    assert sorted(b["storage"]["history"]) == [1, 2]
    assert a["_hook_states"]["ucmt"]["threshold"]["epoch"] == 2
    assert b["_teacher"]["step"] == 4 and "discreteMI/conv5" in b["_hooks"]


def _run_module(module, args, cwd):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # as _one_torch_thread
    out = subprocess.run([sys.executable, "-m", module, *args, "--device", "cpu"], cwd=cwd,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


@pytest.mark.parametrize("module,extra", [
    ("spcl_torch.main", ["Trainer.name=meanteacher"]),
    ("spcl_torch.main_mixup", []),
])
def test_entry_point_resumes_from_a_checkpoint(tmp_path, module, extra):
    first = tmp_path / "first"
    _run_module(module, [*extra, *SMALL, "Trainer.max_epoch=1", f"Trainer.save_dir={first}"],
                ROOT)
    rows = list(csv.DictReader(open(first / "storage.csv")))
    assert len(rows) == 1
    second = tmp_path / "second"
    out = _run_module(module, [*extra, *SMALL, "Trainer.max_epoch=2",
                               f"trainer_checkpoint={first / 'last.ckpt'}",
                               f"Trainer.save_dir={second}"], ROOT)
    assert 0.0 <= float(out.stdout.strip().splitlines()[-1]) <= 1.0
    rows = list(csv.DictReader(open(second / "storage.csv")))
    assert [int(r[next(iter(r))]) for r in rows] == [1, 2]  # epoch 1 restored, epoch 2 run
    last = load_checkpoint(str(second / "last.ckpt"))
    assert last["cur_epoch"] == 2
    if module == "spcl_torch.main":
        assert last["_teacher"]["step"] == 4  # 2 restored + 2 trained


@pytest.mark.parametrize("name", ["base.yaml", "specific/production_semi.yaml",
                                  "specific/mt.yaml", "specific/uda.yaml", "hooks/mixup.yaml"])
def test_chip_smoke_config_transcriptions_match_the_files(name):
    """chip_smoke.py runs slice E without pyyaml from transcribed config
    files (the GPU machine has none): each transcription equals its file,
    and their merge is what ConfigManager merges for `main.py`."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from spcl_torch import CONFIG_PATH
    from spcl_torch.configure import ConfigManager
    from spcl_torch.utils.utils import yaml_load
    assert chip_smoke.CONFIG_FILES[name] == yaml_load(Path(CONFIG_PATH) / name)
    merged = ConfigManager(*[str(Path(CONFIG_PATH) / f) for f in chip_smoke.SEMI_FILES],
                           strict=False).parse_args([]).merged_config
    assert chip_smoke._merged(*chip_smoke.SEMI_FILES) == merged


def test_semi_trainer_device_data_true_equals_false(tmp_path):
    """The unlabeled stream through the device store (index vectors gathered
    on the device) and through host batches (`device_prefetch`) train the
    same function: step metrics and final weights equal to the bit."""
    runs = {}
    for on in (True, False):
        config = _config(tmp_path / str(on), max_epoch=1, **MT_UDA)
        config["Trainer"]["device_data"] = on
        torch.manual_seed(0)  # the same initial weights
        trainer = build_trainer(config, device="cpu")
        trainer.init()
        trainer.start_training()
        runs[on] = (trainer.step_metrics, trainer.model.state_dict(),
                    trainer.teacher.state_dict()["model"])
    (m_on, s_on, t_on), (m_off, s_off, t_off) = runs[True], runs[False]
    assert len(m_on) == 2 and m_on == m_off
    for k in s_on:
        assert torch.equal(s_on[k], s_off[k]) and torch.equal(t_on[k], t_off[k]), k
