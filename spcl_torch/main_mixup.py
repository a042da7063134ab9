#!/usr/bin/env python
"""The MixUp baseline on the GPU: the counterpart of `main_mixup.py`
(reference main_mixup.py:21-68).

    python -m spcl_torch.main_mixup [Key.Sub=value ...] [--opt-path ...] [--device cuda]

Merges config/base.yaml + config/hooks/mixup.yaml (+ --opt-path files +
dotted CLI overrides) and trains the mixup trainer (`Trainer.name` is set to
`mixup`; without a `Trainer.save_dir` it writes to runs/mixup).
`trainer_checkpoint` resumes. Prints the best val DSC.
"""
from pathlib import Path

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.main import cli, run


def main(argv=None, *, device="cuda"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                       str(Path(CONFIG_PATH) / "hooks" / "mixup.yaml"),
                       strict=False).parse_args(argv)
    return run(mixup_config(cm.merged_config), device)


def mixup_config(config):
    """The merged config as the mixup run takes it (reference main_mixup.py)."""
    trainer_cfg = config.setdefault("Trainer", {})
    trainer_cfg["name"] = "mixup"
    trainer_cfg.setdefault("save_dir", "runs/mixup")
    return config


if __name__ == "__main__":
    cli(main)
