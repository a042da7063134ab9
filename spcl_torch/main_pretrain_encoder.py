#!/usr/bin/env python
"""The paper's end-to-end pipeline on the GPU: encoder pretrain -> fine-tune
sweep (both phases of `main_pretrain_encoder.py`).

    python -m spcl_torch.main_pretrain_encoder [Key.Sub=value ...] \
        [--opt-path config/specific/selfpaced_infonce.yaml] [--device cuda]

Merges config/base.yaml + config/pretrain.yaml (+ --opt-path files + dotted
CLI overrides; needs pyyaml) and splits it into a pretrain config (`pre_`
overrides) and a fine-tune config (`ft_` overrides). Phase 1 pretrains the
UNet encoder to Conv5 with the configured (self-paced) InfoNCE hooks and
writes `<save_dir>/pre/last.ckpt`; phase 2 (`entry.val`) fine-tunes the whole
UNet from it at every labeled ratio (`Data.ratios`, else the dataset's ratio
zoo) under `<save_dir>/tra_<ratio>/`. Returns and prints {ratio: best val DSC}.
`Arch.small_c_layout=pallas` runs Conv1/Conv2 through the fused CUDA stages
in both phases; `--device cpu` runs everything on the plain versions.

`Trainer.mesh=N` (or `auto`: one rank per visible card) trains on N ranks:
this process starts N local ranks (`parallel.mesh.run_ranks`), each runs
both phases on its rows of every global batch, and rank 0's scores come back.
With fewer cards than ranks the ranks share cards and the collectives go
through gloo; `--device cpu` runs the ranks on the CPU. To place the ranks
yourself, start one process per rank with SPCL_COORDINATOR=host:port,
SPCL_NUM_PROCESSES=N and SPCL_PROCESS_ID=rank set: such a process starts no
further ranks.
"""
import argparse
import logging
import sys
from pathlib import Path
from typing import Optional

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import build_trainer, separate_pretrain_finetune_configs, val
from spcl_torch.parallel import mesh
from spcl_torch.utils import config_logger, fix_all_seed


def main(argv=None, *, device="cuda", until_check: str = "Conv5"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                       str(Path(CONFIG_PATH) / "pretrain.yaml"),
                       strict=False).parse_args(argv)
    config = cm.merged_config
    return mesh.run_ranks(config.get("Trainer", {}).get("mesh", 0), run,
                          (config, device, until_check), device=device)


def run(config, device="cuda", until_check: Optional[str] = "Conv5",
        trainer_name: str = "pretrain_encoder"):
    """Both phases from a merged config, in this process (one rank of the run
    under `Trainer.mesh`). `trainer_name` is the pretrain trainer
    (`pretrain_decoder` for `spcl_torch.main_pretrain_decoder`)."""
    pretrain_config, ft_config = separate_pretrain_finetune_configs(config)
    save_dir = config.get("Trainer", {}).get("save_dir", f"runs/{trainer_name}")
    mesh.initialize_distributed(device=device)  # no-op unless SPCL_* name a run
    master = mesh.on_master()
    config_logger(save_dir if master else None,
                  level=logging.INFO if master else logging.WARNING)
    fix_all_seed(int(config.get("RandomSeed", 10)))

    pretrain_config.setdefault("Trainer", {})["name"] = trainer_name
    trainer = build_trainer(pretrain_config, save_dir=str(Path(save_dir) / "pre"),
                            pretrain=True, device=device)
    if until_check and trainer._forward_until != until_check:
        raise RuntimeError(f"pretraining stops at {trainer._forward_until}, "
                           f"expected {until_check}")  # reference :65-67
    trainer.init()
    trainer.start_training()
    ckpt = str(Path(save_dir) / "pre" / "last.ckpt")
    return val(base_config=ft_config, pretrained_checkpoint=ckpt, save_dir=save_dir,
               device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(sys.argv[1:])
    print(main(rest, device=ns.device))
