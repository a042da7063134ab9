#!/usr/bin/env python
"""The adversarial semi-supervised baseline on the GPU: the counterpart of
`main_adv.py` (reference main_adv.py:16-52).

    python -m spcl_torch.main_adv [Key.Sub=value ...] [--opt-path ...] [--device cuda]

Merges config/base.yaml + config/hooks/adv.yaml (+ --opt-path files + dotted
CLI overrides; needs pyyaml) and trains the adversarial trainer
(`Trainer.name` is set to `adv`; without a `Trainer.save_dir` it writes to
runs/adv): the UNet as the generator against a discriminator on its softmax,
weighted by `Trainer.reg_weight`, with `Trainer.dis_consider_image` feeding
the image too. `trainer_checkpoint` resumes. Prints the best val DSC.
"""
from pathlib import Path

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.main import cli, run


def main(argv=None, *, device="cuda"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                       str(Path(CONFIG_PATH) / "hooks" / "adv.yaml"),
                       strict=False).parse_args(argv)
    return run(adv_config(cm.merged_config), device)


def adv_config(config):
    """The merged config as the adversarial run takes it (reference main_adv.py)."""
    trainer_cfg = config.setdefault("Trainer", {})
    trainer_cfg["name"] = "adv"
    trainer_cfg.setdefault("save_dir", "runs/adv")
    return config


if __name__ == "__main__":
    cli(main)
