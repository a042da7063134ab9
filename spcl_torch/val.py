#!/usr/bin/env python
"""The fine-tune sweep CLI: the counterpart of the root `val.py` (reference
val.py:24-66).

    python -m spcl_torch.val Arch.checkpoint=runs/pre/last.ckpt \
        Trainer.save_dir=runs/sweep [Key.Sub=value ...] [--device cuda]

Merges config/base.yaml with the dotted overrides (needs pyyaml) and runs
`spcl_torch.entry.val` from the pretrained `Arch.checkpoint`, which it
requires: one fine-tune run per labeled ratio, each warm-started from it.
Prints and returns {ratio: best val DSC}. `--device cpu` runs on the CPU.
"""
from pathlib import Path

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import val as val_sweep
from spcl_torch.main import cli
from spcl_torch.utils import config_logger, fix_all_seed


def main(argv=None, *, device="cuda"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"), strict=False).parse_args(argv)
    return run(cm.merged_config, device)


def run(config, device="cuda"):
    """The sweep from a merged config; SystemExit without `Arch.checkpoint`."""
    ckpt = (config.get("Arch") or {}).get("checkpoint")
    if not ckpt:
        raise SystemExit("set Arch.checkpoint=<pretrained .ckpt>")
    save_dir = config.get("Trainer", {}).get("save_dir", "runs/val_sweep")
    config_logger(save_dir)
    fix_all_seed(int(config.get("RandomSeed", 10)))
    config["Arch"]["checkpoint"] = None  # val() sets it again for each ratio
    return val_sweep(base_config=config, pretrained_checkpoint=ckpt, save_dir=save_dir,
                     device=device)


if __name__ == "__main__":
    cli(main)
