#!/usr/bin/env python
"""Experiment grid generator: the counterpart of `scripts/generate_jobs.py`
(reference script/utils.py:78-186 + semi_seg/scripts/run_*).

Expands hyperparameter grids into `python -m spcl_torch.main*` command lines,
one job per grid point, with the per-dataset lr/epoch/batch zoos filled in.
The lines go to stdout: pipe them into xargs, GNU parallel, or a scheduler:

    python -m spcl_torch.scripts.generate_jobs baseline --data acdc --seeds 10 20 30 | bash
    python -m spcl_torch.scripts.generate_jobs spinfonce --data acdc \
        --grid begin_values=1000,10000 end_values=20,80 mode=soft,hard
"""
from __future__ import annotations

import argparse
import itertools

from spcl_torch.constants import (data2class_numbers, data2input_dim, ft_lr_zooms,
                                  ft_max_epoch_zoo, num_batches_zoo, pre_lr_zooms,
                                  pre_max_epoch_zoo, ratio_zoo)

FLAVORS = ("baseline", "infonce", "spinfonce", "mixup", "adv", "semi_mt",
           "semi_consistency", "udaiic")
_SEMI_HOOKS = {"semi_mt": ("mt", "mt.yaml"), "semi_consistency": ("cons", "consistency.yaml"),
               "udaiic": ("udaiic", "udaiic.yaml")}


def grid_search(**kwargs):
    keys = list(kwargs)
    vals = [v if isinstance(v, (list, tuple)) else [v] for v in kwargs.values()]
    for combo in itertools.product(*vals):
        yield dict(zip(keys, combo))


def common_conditions(data: str) -> str:
    return (f"Data.name={data} Trainer.num_batches={num_batches_zoo.get(data, 200)} "
            f"Arch.input_dim={data2input_dim[data]} Arch.num_classes={data2class_numbers[data]}")


def param_string(params: dict) -> str:
    return "/".join(f"{k}_{v}" for k, v in params.items())


def baseline_jobs(args) -> list:
    jobs = []
    for seed in args.seeds:
        for scans in ratio_zoo[args.data]:
            save = f"{args.save_dir}/Seed_{seed}/baseline/tra_{scans:03d}"
            jobs.append(
                f"python -m spcl_torch.main Trainer.name=ft Trainer.save_dir={save} "
                f"Optim.lr={ft_lr_zooms[args.data]:.7f} RandomSeed={seed} "
                f"Data.labeled_scan_num={scans} "
                f"Trainer.max_epoch={ft_max_epoch_zoo.get(args.data, 60)} "
                f"{common_conditions(args.data)}")
    return jobs


def pretrain_jobs(args, hook_yaml: str) -> list:
    jobs = []
    grid = dict(kv.split("=", 1) for kv in args.grid) if args.grid else {}
    grid = {k: v.split(",") for k, v in grid.items()}
    for seed in args.seeds:
        for params in grid_search(**grid) if grid else [{}]:
            save = f"{args.save_dir}/Seed_{seed}/{param_string(params) or 'default'}"
            extra = " ".join(f"SPInfonceParams.{k}={v}" for k, v in params.items())
            jobs.append(
                f"python -m spcl_torch.main_pretrain_encoder Trainer.save_dir={save} "
                f"Optim.pre_lr={pre_lr_zooms[args.data]:.7f} "
                f"Optim.ft_lr={ft_lr_zooms[args.data]:.7f} RandomSeed={seed} "
                f"Trainer.pre_max_epoch={pre_max_epoch_zoo.get(args.data, 80)} "
                f"Trainer.ft_max_epoch={ft_max_epoch_zoo.get(args.data, 60)} "
                f"{common_conditions(args.data)} {extra} "
                f"--opt-path config/hooks/{hook_yaml}")
    return jobs


def jobs_for(args) -> list:
    """The command lines of `args.flavor`."""
    if args.flavor == "baseline":
        return baseline_jobs(args)
    if args.flavor in ("infonce", "spinfonce"):
        return pretrain_jobs(args, f"{args.flavor}.yaml")
    if args.flavor in ("mixup", "adv"):
        return [f"python -m spcl_torch.main_{args.flavor} "
                f"Trainer.save_dir={args.save_dir}/Seed_{s}/{args.flavor} "
                f"RandomSeed={s} {common_conditions(args.data)}" for s in args.seeds]
    tag, hook_yaml = _SEMI_HOOKS[args.flavor]
    return [f"python -m spcl_torch.main Trainer.name=semi "
            f"Trainer.save_dir={args.save_dir}/Seed_{s}/{tag} "
            f"RandomSeed={s} {common_conditions(args.data)} "
            f"--opt-path config/hooks/{hook_yaml}" for s in args.seeds]


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("flavor", choices=FLAVORS)
    p.add_argument("--data", default="acdc")
    p.add_argument("--seeds", nargs="+", type=int, default=[10])
    p.add_argument("--save-dir", default="runs/grid")
    p.add_argument("--grid", nargs="*", default=[],
                   help="k=v1,v2 pairs expanded as a product (spinfonce params)")
    jobs = jobs_for(p.parse_args(argv))
    for j in jobs:
        print(j)
    return jobs


if __name__ == "__main__":
    main()
