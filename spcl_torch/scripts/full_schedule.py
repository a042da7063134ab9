#!/usr/bin/env python
"""The paper's whole schedule, timed end to end on synthetic data: the
counterpart of `scripts/full_schedule.py`.

    python -m spcl_torch.scripts.full_schedule [--device cuda] [--out runs/full]

Runs the pinned workload of BASELINE.md: 80 epochs x 200 batches of
self-paced contrastive encoder pretraining, then the fine-tune sweep (60
epochs x 200 batches per labeled ratio, 1, 2 and 4 scans) with val and test
evaluation after every epoch and best checkpointing. Each phase runs in its
own `python -m spcl_torch.main` process with `Trainer.defer_reads` (no
device -> host read until the end of the run). Prints the table of wall
times with the best val DSC per ratio (read from each run's storage.csv) and
writes it to `<out>/schedule.md`.
"""
import argparse
import csv
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

COMMON = [
    "RandomSeed=10",
    "Arch.max_channel=256", "Arch.num_classes=4", "Arch.input_dim=1",
    "Data.synthetic=true", "Data.canvas=256", "Data.crop=224",
    "Data.synthetic_scans=24", "Data.synthetic_test_scans=8",
    "LabeledLoader.batch_size=5", "UnlabeledLoader.batch_size=5",
    "Trainer.num_batches=200", "Trainer.defer_reads=true",
    "Scheduler.multiplier=300", "Scheduler.warmup_max=10",
]
RATIOS = (1, 2, 4)


def run_phase(tag, args, device):
    """One entry-point process from the repo root; raises if it fails."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "spcl_torch.main", "--device", device] + args,
                          cwd=str(REPO), capture_output=True, text=True)
    dt = time.time() - t0
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-3000:], flush=True)
        raise RuntimeError(f"phase {tag} failed")
    print(f"{tag}: {dt:.0f}s", flush=True)
    return dt


def best_score(run_dir) -> float:
    """The best val DSC of a run (its storage.csv; empty and NaN cells skipped)."""
    with open(REPO / run_dir / "storage.csv", newline="") as f:
        vals = [float(row["val/dice/DSC_mean"]) for row in csv.DictReader(f)
                if row.get("val/dice/DSC_mean") not in (None, "")]
    return max(v for v in vals if not math.isnan(v))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="runs/full", help="run directory, under the repo root")
    args = ap.parse_args(argv)

    t_all = time.time()
    t_pre = run_phase("pretrain", COMMON + [
        "Trainer.name=pretrain_encoder", "Trainer.max_epoch=80",
        f"Trainer.save_dir={args.out}/pre", "Optim.lr=5e-7",
        "ContrastiveLoaderParams.scan_sample_num=10",
        "--opt-path", "config/hooks/spinfonce.yaml",
    ], args.device)
    t_fts, scores = [], {}
    for r in RATIOS:
        t_fts.append(run_phase(f"ft_{r}", COMMON + [
            "Trainer.name=ft", "Trainer.max_epoch=60",
            f"Trainer.save_dir={args.out}/tra_{r}", "Optim.lr=2e-7",
            f"Data.labeled_scan_num={r}",
            f"Arch.checkpoint={args.out}/pre/last.ckpt",
        ], args.device))
        scores[r] = best_score(f"{args.out}/tra_{r}")
    total = time.time() - t_all

    table = f"""## Full reference schedule (pinned workload, BASELINE.md), device {args.device}

One `python -m spcl_torch.main` process per phase, `Trainer.defer_reads=true`.

| phase | schedule | wall-clock |
|---|---|---|
| SP-InfoNCE encoder pretrain | 80 x 200 batches (30 slices, 2 views) = 16,000 steps | {t_pre:.0f}s |
| finetune ratio sweep {list(RATIOS)} | 3 x (60 x 200 steps + 120 eval epochs) = 36,000 steps | {sum(t_fts):.0f}s ({', '.join(f'{t:.0f}s' for t in t_fts)}) |
| **total pipeline** | 52,000 train steps + evals + checkpoints | **{total / 60:.1f} min** |

Best val DSC per ratio: `{json.dumps({k: round(v, 4) for k, v in scores.items()})}`
(synthetic data: the reference's schedule, shapes and step counts).
"""
    out = REPO / args.out
    out.mkdir(parents=True, exist_ok=True)
    (out / "schedule.md").write_text(table)
    print(table, flush=True)
    print(f"TOTAL {total / 60:.1f} min; scores {scores}", flush=True)
    return scores


if __name__ == "__main__":
    main()
