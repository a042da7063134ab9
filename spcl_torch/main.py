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

`Trainer.mesh=N` (or `auto`: one rank per visible card) trains on N ranks:
this process starts N local ranks (`parallel.mesh.run_ranks`), each trains
on its rows of every global batch, and rank 0's score comes back. With
fewer cards than ranks the ranks share cards and the collectives go through
gloo; `--device cpu` runs the ranks on the CPU. To place the ranks
yourself, start one process per rank with SPCL_COORDINATOR=host:port,
SPCL_NUM_PROCESSES=N and SPCL_PROCESS_ID=rank set: such a process starts no
further ranks. `main_mixup.py` and `main_adv.py` run through `run` too.
"""
import argparse
import logging
import sys
from pathlib import Path

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import build_trainer
from spcl_torch.parallel import mesh
from spcl_torch.utils import config_logger, fix_all_seed


def main(argv=None, *, device="cuda"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"), strict=False).parse_args(argv)
    return run(cm.merged_config, device)


def run(config, device="cuda"):
    """Build, init, resume (`trainer_checkpoint`) and train from a merged
    config, in this process or in the ranks `Trainer.mesh` asks for."""
    return mesh.run_ranks(config.get("Trainer", {}).get("mesh", 0), run_rank,
                          (config, device), device=device)


def run_rank(config, device="cuda"):
    """`run` in this process: one rank of the run under `Trainer.mesh`."""
    save_dir = config.get("Trainer", {}).get("save_dir", "runs/tmp")
    mesh.initialize_distributed(device=device)  # no-op unless SPCL_* name a run
    master = mesh.on_master()
    config_logger(save_dir if master else None,
                  level=logging.INFO if master else logging.WARNING)
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
