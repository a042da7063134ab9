#!/usr/bin/env python
"""Single-stage run of one trainer on the GPU: the counterpart of `main.py`
(reference main.py:18-83).

    python -m spcl_torch.main Trainer.name=semi Data.labeled_scan_num=4 \
        [--opt-path config/specific/mt.yaml] [Key.Sub=value ...] [--device cuda]

Merges config/base.yaml (+ --opt-path files + dotted CLI overrides; needs
pyyaml) and trains `Trainer.name`: `semi` (the default), a legacy preset
name (`uda`, `entropy`, `meanteacher`, `ucmeanteacher`, `iic`, `udaiic`,
`midl`, `mine`, `infonce`, `infoncemt`, `iicmeanteacher`: the semi trainer
with that preset's hooks), `mixup`, `ft` or `pretrain`. `trainer_checkpoint=
<path>/last.ckpt` resumes the run that wrote it. Returns (and prints) the
best val DSC (0.0 for pretrain). `--device cpu` runs the plain versions of
the kernels on the CPU.
"""
import argparse
import sys
from pathlib import Path

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import build_trainer
from spcl_torch.utils import config_logger, fix_all_seed


def main(argv=None, *, device="cuda"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"), strict=False).parse_args(argv)
    return run(cm.merged_config, device)


def run(config, device="cuda"):
    """Build, init, resume (`trainer_checkpoint`) and train from a merged config."""
    save_dir = config.get("Trainer", {}).get("save_dir", "runs/tmp")
    config_logger(save_dir)
    fix_all_seed(int(config.get("RandomSeed", 10)))
    pretrain = str(config.get("Trainer", {}).get("name", "")).startswith("pretrain")
    trainer = build_trainer(config, save_dir=save_dir, pretrain=pretrain, device=device)
    trainer.init()
    ckpt = config.get("trainer_checkpoint")
    if ckpt:
        trainer.resume_from_path(ckpt)
    return trainer.start_training()


def cli(entry):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(sys.argv[1:])
    print(entry(rest, device=ns.device))


if __name__ == "__main__":
    cli(main)
