"""`Trainer.name: infoncepretrain` (spcl_tpu entry/common.py:111-115): the
encoder-pretrain trainer with the `infonce` preset's InfonceParams merged
under the config, explicit blocks winning.

- The config the port builds under the name equals spcl_tpu's merge of the
  same input, key for key (spcl_tpu's preset table and merge, imported here
  only).
- The trainer is `PretrainEncoderTrainer` with `forward_until == "Conv5"`
  and the stages up to Conv5 trainable; an explicit temperature wins.
- One epoch under the name equals one under `pretrain_encoder` with the
  merged config, to the bit (step losses and every weight).
- `python -m spcl_torch.main Trainer.name=infoncepretrain ... --device cpu`
  runs to its end and prints 0.0.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spcl_tpu.configure.dictionary_utils import \
    dictionary_merge_by_hierachy as jax_merge
from spcl_tpu.hooks.creator import LEGACY_TRAINER_PRESETS as JAX_PRESETS
from spcl_torch.entry import build_trainer
from spcl_torch.models import stages_from_range
from spcl_torch.training import PretrainEncoderTrainer
from spcl_torch.utils import fix_all_seed

ROOT = Path(__file__).resolve().parents[1]
HOOK = "infonce/Conv5/partition"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(save_dir, name="infoncepretrain", **blocks):
    config = {
        "RandomSeed": 5,
        "Arch": {"input_dim": 1, "num_classes": 4, "max_channel": 32},
        "Optim": {"name": "adam", "lr": 1e-3},
        "Data": {"name": "acdc", "synthetic": True, "canvas": 40, "crop": 32,
                 "synthetic_scans": 4, "synthetic_test_scans": 2, "labeled_scan_num": 1},
        "ContrastiveLoaderParams": {"scan_sample_num": 4, "partition_sample_num": 1},
        "Trainer": {"name": name, "max_epoch": 1, "num_batches": 2, "save_dir": str(save_dir)},
    }
    config.update(blocks)
    return config


def _build(config):
    fix_all_seed(int(config["RandomSeed"]))
    return build_trainer(config, save_dir=config["Trainer"]["save_dir"], device="cpu")


def test_merged_config_equals_spcl_tpu(tmp_path):
    config = _config(tmp_path)
    trainer = _build(config)
    want = jax_merge(JAX_PRESETS["infonce"], config)
    assert trainer._config == want
    assert trainer._config["InfonceParams"] == {"feature_names": "Conv5", "weights": 1.0,
                                                "contrast_ons": "partition"}
    assert "InfonceParams" not in config  # the caller's config is not changed


def test_trainer_is_the_encoder_pretrain_trainer(tmp_path):
    trainer = _build(_config(tmp_path))
    assert type(trainer) is PretrainEncoderTrainer
    assert trainer._forward_until == "Conv5"
    assert trainer._trainable_stages == list(stages_from_range(None, "Conv5"))
    assert [h.name for h in trainer._hooks] == [HOOK]


def test_explicit_temperature_wins(tmp_path):
    config = _config(tmp_path, InfonceParams={"temperature": 0.5})
    trainer = _build(config)
    assert trainer._config["InfonceParams"] == jax_merge(
        JAX_PRESETS["infonce"], config)["InfonceParams"]
    assert trainer._config["InfonceParams"]["temperature"] == 0.5
    assert trainer._hooks[0].temperature == 0.5
    assert _build(_config(tmp_path / "default"))._hooks[0].temperature == 0.07


def _epoch(config):
    trainer = _build(config)
    trainer.init()
    trainer.start_training()
    return ([m["reg_loss"] for m in trainer.step_metrics],
            {k: v.detach().clone() for k, v in trainer._model.state_dict().items()})


def test_one_epoch_equals_pretrain_encoder_with_the_merged_config(tmp_path):
    named = _config(tmp_path / "named")
    losses, weights = _epoch(named)
    merged = jax_merge(JAX_PRESETS["infonce"], _config(tmp_path / "plain", "pretrain_encoder"))
    plain_losses, plain_weights = _epoch(merged)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses == plain_losses
    assert weights.keys() == plain_weights.keys()
    for k, v in weights.items():
        assert torch.equal(v, plain_weights[k]), k
    assert not torch.equal(weights["_Conv5.conv.0.weight"],
                           _build(_config(tmp_path / "fresh"))._model.state_dict()[
                               "_Conv5.conv.0.weight"])


def test_main_entry_point_runs_infoncepretrain(tmp_path):
    args = ["Trainer.name=infoncepretrain", "Data.synthetic=true", "Data.canvas=40",
            "Data.crop=32", "Arch.max_channel=32", "Data.synthetic_scans=4",
            "Data.synthetic_test_scans=2", "ContrastiveLoaderParams.scan_sample_num=4",
            "Trainer.max_epoch=1", "Trainer.num_batches=2", "Optim.lr=1e-3",
            f"Trainer.save_dir={tmp_path}"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "spcl_torch.main", *args, "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert float(out.stdout.strip().splitlines()[-1]) == 0.0
    assert (tmp_path / "last.ckpt").exists()
