#!/usr/bin/env python
"""The paper's encoder pretraining on the GPU (phase 1 of
`main_pretrain_encoder.py`).

    python -m spcl_torch.main_pretrain_encoder [Key.Sub=value ...] \
        [--opt-path config/specific/selfpaced_infonce.yaml] [--device cuda]

Merges config/base.yaml + config/pretrain.yaml (+ --opt-path files + dotted
CLI overrides; needs pyyaml), keeps the `pre_`-prefixed overrides, and
pretrains the UNet encoder to Conv5 with the configured (self-paced) InfoNCE
hooks. Writes `<save_dir>/pre/last.ckpt` and returns its path. The
fine-tune sweep over labeled ratios (phase 2) is not ported yet.
"""
import argparse
import sys
from pathlib import Path

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import build_trainer, separate_pretrain_finetune_configs
from spcl_torch.utils import config_logger, fix_all_seed


def main(argv=None, *, device="cuda", until_check: str = "Conv5") -> str:
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                       str(Path(CONFIG_PATH) / "pretrain.yaml"),
                       strict=False).parse_args(argv)
    config = cm.merged_config
    pretrain_config, _ = separate_pretrain_finetune_configs(config)
    save_dir = config.get("Trainer", {}).get("save_dir", "runs/pretrain_encoder")
    config_logger(save_dir)
    fix_all_seed(int(config.get("RandomSeed", 10)))

    pretrain_config.setdefault("Trainer", {})["name"] = "pretrain_encoder"
    trainer = build_trainer(pretrain_config, save_dir=str(Path(save_dir) / "pre"),
                            pretrain=True, device=device)
    if until_check and trainer._forward_until != until_check:
        raise RuntimeError(f"pretraining stops at {trainer._forward_until}, "
                           f"expected {until_check}")  # reference :65-67
    trainer.init()
    trainer.start_training()
    return str(Path(save_dir) / "pre" / "last.ckpt")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(sys.argv[1:])
    print(main(rest, device=ns.device))
