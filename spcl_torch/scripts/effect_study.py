#!/usr/bin/env python
"""The paper's effect on the hard synthetic regime, through spcl_torch: the
counterpart of `scripts/effect_study.py`.

    python -m spcl_torch.scripts.effect_study [--device cuda] [--dtype float32]
        [--seeds 10,20,30,40,50] [--arms scratch,spsoft_corrupt] [--jobs 3] [--force]
        [--backends deterministic|defaults]
    python -m spcl_torch.scripts.effect_study --arm spsoft_corrupt --seed 10
    python -m spcl_torch.scripts.effect_study --collect [--dtype bfloat16]

Claims measured (means +/- np.std over seeds):
  (a) fine-tuning from SP-InfoNCE pretraining beats training from scratch
      at 2 labeled scans of 20;
  (b) with 80% corrupted contrastive meta-labels, self-paced InfoNCE
      pretraining beats plain InfoNCE pretraining (reference
      contrast_loss3.py:113-222: downweight unreliable positives).

The protocol is spcl_tpu's, constant for constant and config key for key:
UNet-128, crop 48 of a 64 canvas, `synthetic: hard` (20 train scans, 8
test), pretraining 15 epochs x 30 contrastive batches (10 scans x 3
partitions = 30 slices, 2N = 60 views), fine-tuning 25 epochs x 30 batches
of 8 labeled slices, Adam 1e-3, best per-scan val DSC. Each (arm, seed)
runs in its own process, on the card unless `--device cpu`. `run_arm`
trains under `deterministic_backends` (cuDNN deterministic, TF32 off), so
that a run on the card repeats to the bit; `--backends defaults` keeps
PyTorch's, under which one seed's best DSC spreads from run to run (ROADMAP
C12). `--dtype bfloat16` sets only `Arch.dtype`. Records land in
`runs/effect_study_torch/` (bf16: its `bfloat16/` folder), one
`<arm>_s<seed>.json` each.

`collect` prints the table, the paired deltas (a), (a'), (b), (b') with their
per-seed values, and `gate`: each arm's mean against spcl_tpu's round-5
table (RESULTS.md:502-510) within 3 combined standard errors.
"""
import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "runs" / "effect_study_torch"
SEEDS = (10, 20, 30)
CORRUPT = 0.8
DTYPES = ("float32", "bfloat16")
BACKENDS = ("deterministic", "defaults")

# small-but-not-saturating budget (spcl_tpu's calibration, RESULTS.md round 5)
CANVAS, CROP = 64, 48
PRE_EPOCHS, PRE_BATCHES = 15, 30
FT_EPOCHS, FT_BATCHES = 25, 30
LABELED_SCANS = 2

# spcl_tpu's round-5 table on the CPU (RESULTS.md:502-510): best val DSC,
# (mean, np.std, n seeds) per arm
JAX_DICE = {
    "scratch": (0.226, 0.096, 5),
    "plain_clean": (0.341, 0.012, 3),
    "sp_clean": (0.319, 0.010, 3),
    "spsoft_clean": (0.347, 0.036, 5),
    "plain_corrupt": (0.275, 0.063, 5),
    "sp_corrupt": (0.289, 0.013, 3),
    "spsoft_corrupt": (0.330, 0.028, 5),
}
# its linear probe of the clean partition from frozen Conv5 features
# (RESULTS.md:525-533): (mean, np.std, n); n is not stated there and is
# taken as the arm's seeds in the table above
JAX_PROBE = {
    "spsoft_clean": (0.537, 0.021, 5),
    "plain_clean": (0.467, 0.046, 3),
    "spsoft_corrupt": (0.390, 0.026, 5),
    "plain_corrupt": (0.367, 0.024, 5),
}
# an arm passes when |mean_port - mean_jax| <= GATE_SE combined standard errors
GATE_SE = 3.0
POLL_S = 1.0  # seconds between looks at the workers


def out_dir(dtype: str = "float32") -> Path:
    """Where the records of a dtype's study live."""
    return OUT if dtype == "float32" else OUT / dtype


def _data_block(meta_corrupt=0.0):
    return {"name": "acdc", "synthetic": "hard", "canvas": CANVAS,
            "crop": CROP, "synthetic_scans": 20, "synthetic_test_scans": 8,
            "labeled_scan_num": LABELED_SCANS,
            "meta_corrupt": float(meta_corrupt)}


def _arch_block(dtype="float32"):
    return {"input_dim": 1, "num_classes": 4, "max_channel": 128,
            "dtype": dtype}


def pretrain_config(seed, sp, corrupt, save_dir, dtype="float32"):
    hook_block = {"feature_names": "Conv5", "weights": 1.0,
                  "contrast_ons": "partition", "temperature": 0.07}
    cfg = {
        "RandomSeed": seed,
        "Arch": _arch_block(dtype),
        "Data": _data_block(meta_corrupt=corrupt),
        "Optim": {"name": "adam", "lr": 1e-3},
        "ContrastiveLoaderParams": {"scan_sample_num": 10,
                                    "partition_sample_num": 1},
        "Trainer": {"name": "pretrain_encoder", "max_epoch": PRE_EPOCHS,
                    "num_batches": PRE_BATCHES, "save_dir": save_dir},
    }
    if sp:
        # sp=(begin, end, mode) pins an arm's gamma schedule; True is the
        # paper's 3->14 hard schedule (spcl_tpu scripts/effect_study.py:66-71)
        begin, end, mode = (3, 14, "hard") if sp is True else sp
        cfg["SPInfonceParams"] = dict(hook_block, begin_values=begin,
                                      end_values=end, p=0.5, mode=mode)
    else:
        cfg["InfonceParams"] = hook_block
    return cfg


def finetune_config(seed, ckpt, save_dir, dtype="float32"):
    return {
        "RandomSeed": seed,
        "Arch": dict(_arch_block(dtype), checkpoint=ckpt),
        "Data": _data_block(),
        "Optim": {"name": "adam", "lr": 1e-3},
        "LabeledLoader": {"batch_size": 8},
        "UnlabeledLoader": {"batch_size": 8},
        "Trainer": {"name": "finetune", "max_epoch": FT_EPOCHS,
                    "num_batches": FT_BATCHES, "save_dir": save_dir},
    }


ARMS = {
    # (a): pretrain > scratch at low labels
    "scratch": dict(pre=None),
    "sp_clean": dict(pre=dict(sp=True, corrupt=0.0)),
    # (b): under corrupted meta-labels, SP > plain
    "plain_corrupt": dict(pre=dict(sp=False, corrupt=CORRUPT)),
    "sp_corrupt": dict(pre=dict(sp=True, corrupt=CORRUPT)),
    # context: plain at clean meta-labels
    "plain_clean": dict(pre=dict(sp=False, corrupt=0.0)),
    # SP with the schedule adapted to the short budget (soft weights,
    # gamma 8->40: keep most pairs while the encoder is young, tighten late)
    "spsoft_clean": dict(pre=dict(sp=(8, 40, "soft"), corrupt=0.0)),
    "spsoft_corrupt": dict(pre=dict(sp=(8, 40, "soft"), corrupt=CORRUPT)),
}


def _ms_per_step(stats) -> float:
    """ms per train step of the epoch these statistics describe (the trainer
    times its steps between two device synchronisations)."""
    return 1e3 / stats["tra"]["throughput"]["steps_per_sec"]


def card_name(device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if not str(device).startswith("cuda"):
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def deterministic_backends():
    """cuDNN's deterministic algorithms, its benchmark off, and TF32 off for
    cuDNN and matmuls (float32 products, as spcl_tpu's study on the CPU)
    inside the block; the previous settings after it."""
    import torch
    b = torch.backends
    saved = (b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
             b.cuda.matmul.allow_tf32)
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
         b.cuda.matmul.allow_tf32) = saved


def run_arm(arm: str, seed: int, *, device="cuda", dtype="float32", out=None,
            backends="deterministic") -> dict:
    """One (arm, seed): pretraining (unless `scratch`), then fine-tuning
    warm-started from its last.ckpt, under `deterministic_backends` (or
    PyTorch's settings with `backends="defaults"`). Writes and returns the
    record."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    if backends not in BACKENDS:
        raise ValueError(f"backends must be one of {BACKENDS}, got {backends!r}")
    out = Path(out) if out is not None else out_dir(dtype)
    with deterministic_backends() if backends == "deterministic" else contextlib.nullcontext():
        rec = _train_arm(arm, seed, device, dtype, out)
    rec["backends"] = backends
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arm}_s{seed}.json").write_text(json.dumps(rec))
    print(json.dumps(rec), flush=True)
    return rec


def _train_arm(arm, seed, device, dtype, out) -> dict:
    """`run_arm`'s training; returns the record without its backends."""
    from spcl_torch.entry import build_trainer
    from spcl_torch.meters.storage import flatten_dict
    from spcl_torch.utils import fix_all_seed

    spec = ARMS[arm]
    base = out / f"{arm}_s{seed}"
    t0 = time.time()
    fix_all_seed(seed)
    ckpt, pre_loss, timing = None, None, {}
    if spec["pre"] is not None:
        pcfg = pretrain_config(seed, spec["pre"]["sp"], spec["pre"]["corrupt"],
                               str(base / "pre"), dtype)
        tr = build_trainer(pcfg, save_dir=str(base / "pre"), pretrain=True, device=device)
        tr.init()
        tr.start_training()
        last = flatten_dict(tr.last_epoch_stats)
        pre_loss = next((float(v) for k, v in last.items() if "reg_loss" in k), None)
        timing["pre_ms_per_step"] = _ms_per_step(tr.last_epoch_stats)
        timing["pre_s"] = time.time() - t0
        ckpt = str(base / "pre" / "last.ckpt")
    t_ft = time.time()
    tr = build_trainer(finetune_config(seed, ckpt, str(base / "ft"), dtype),
                       save_dir=str(base / "ft"), device=device)
    tr.init()
    best = float(tr.start_training())
    timing["ft_ms_per_step"] = _ms_per_step(tr.last_epoch_stats)
    timing["ft_s"] = time.time() - t_ft
    return {"arm": arm, "seed": seed, "best_val_dice": best,
            "pretrain_loss": pre_loss, "wall_s": round(time.time() - t0, 1),
            "device": str(device), "dtype": dtype, "card": card_name(device), **timing}


def gate(rows: dict, reference: dict) -> dict:
    """{arm: verdict} for every arm in both `rows` ({arm: (mean, std, n)})
    and `reference`: the arm passes when |mean - mean_ref| <= GATE_SE x
    sqrt(std_ref^2 / n_ref + std^2 / n)."""
    out = {}
    for arm, (mean, std, n) in rows.items():
        if arm not in reference:
            continue
        ref_mean, ref_std, ref_n = reference[arm]
        bound = GATE_SE * math.sqrt(ref_std ** 2 / ref_n + std ** 2 / n)
        out[arm] = {"port": round(mean, 4), "jax": ref_mean, "diff": round(mean - ref_mean, 4),
                    "bound": round(bound, 4), "pass": abs(mean - ref_mean) <= bound}
    return out


def _paired(records: dict, arm: str, base: str):
    """Per-seed deltas arm - base over the seeds both have, and their mean."""
    seeds = sorted(set(records.get(arm, {})) & set(records.get(base, {})))
    deltas = {s: records[arm][s] - records[base][s] for s in seeds}
    return deltas, (sum(deltas.values()) / len(deltas) if deltas else None)


def collect(out=None, dtype: str = "float32") -> dict:
    """The table of a study's records, the paired deltas and the gate.
    Returns {"rows": {arm: (mean, std, n)}, "gate": ..., "deltas": ...,
    "timing": {arm: means of the records' timing keys}}."""
    import numpy as np

    out = Path(out) if out is not None else out_dir(dtype)
    records, rows, timing = {}, {}, {}
    for arm in ARMS:
        recs = [json.loads(p.read_text()) for p in sorted(out.glob(f"{arm}_s*.json"))]
        if not recs:
            continue
        records[arm] = {r["seed"]: r["best_val_dice"] for r in recs}
        vals = list(records[arm].values())
        rows[arm] = (float(np.mean(vals)), float(np.std(vals)), len(vals))
        timing[arm] = {k: float(np.mean([r[k] for r in recs]))
                       for k in ("wall_s", "pre_ms_per_step", "ft_ms_per_step")
                       if all(r.get(k) is not None for r in recs)}
    print(json.dumps({k: {"mean": round(m, 4), "std": round(s, 4), "n": n, **timing[k]}
                      for k, (m, s, n) in rows.items()}, indent=1))
    deltas = {}
    # spcl_tpu's three, and (a') = RESULTS.md's (a) with the budget-adapted schedule
    for tag, arm, base in (("a", "sp_clean", "scratch"), ("a'", "spsoft_clean", "scratch"),
                           ("b", "sp_corrupt", "plain_corrupt"),
                           ("b'", "spsoft_corrupt", "plain_corrupt")):
        per_seed, mean = _paired(records, arm, base)
        if mean is not None:
            deltas[tag] = {"arms": f"{arm} - {base}", "mean": round(mean, 4),
                           "per_seed": {s: round(d, 4) for s, d in per_seed.items()}}
            print(f"({tag}) {arm} - {base} = {mean:+.4f} paired over seeds "
                  + ", ".join(f"{s}: {d:+.4f}" for s, d in per_seed.items()))
    verdict = gate(rows, JAX_DICE)
    for arm, v in verdict.items():
        print(f"gate {arm}: port {v['port']:.4f} jax {v['jax']:.4f} diff {v['diff']:+.4f} "
              f"bound {v['bound']:.4f} {'pass' if v['pass'] else 'MISS'}")
    return {"rows": rows, "gate": verdict, "deltas": deltas, "timing": timing}


def _worker_cmd(arm, seed, args):
    """The command of one (arm, seed) worker."""
    return [sys.executable, "-m", "spcl_torch.scripts.effect_study", "--arm", arm,
            "--seed", str(seed), "--device", args.device, "--dtype", args.dtype,
            "--backends", args.backends, "--out", str(args.out)]


def orchestrate(args) -> dict:
    """Every (arm, seed) of `args` without a record (all with `--force`) in
    its own process, `args.jobs` at a time; raises SystemExit when a worker
    fails, before anything is collected; else returns `collect`'s result."""
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else list(SEEDS)
    arms = args.arms.split(",") if args.arms else list(ARMS)
    unknown = [a for a in arms if a not in ARMS]
    if unknown:
        raise SystemExit(f"unknown arms {unknown}; known: {sorted(ARMS)}")
    out = Path(args.out)
    todo = [(a, s) for a in arms for s in seeds
            if args.force or not (out / f"{a}_s{s}.json").exists()]
    out.mkdir(parents=True, exist_ok=True)
    if todo and args.device.startswith("cuda"):
        # one nvcc build before the workers start, not one per worker
        from spcl_torch.ops import supcon_cuda
        supcon_cuda.build()
    procs, failed = [], []
    while todo or procs:
        while todo and len(procs) < args.jobs:
            a, s = todo.pop(0)
            log = open(out / f"{a}_s{s}.log", "w")
            procs.append((a, s, subprocess.Popen(
                _worker_cmd(a, s, args), stdout=log, stderr=subprocess.STDOUT,
                cwd=str(REPO)), log))
            print(f"launched {a} seed={s}", flush=True)
        time.sleep(POLL_S)
        for item in list(procs):
            a, s, p, log = item
            if p.poll() is not None:
                log.close()
                print(f"done {a} seed={s} rc={p.returncode}", flush=True)
                if p.returncode != 0:
                    failed.append((a, s))
                procs.remove(item)
    if failed:
        # no table over partial or unbalanced seed sets
        raise SystemExit(
            f"{len(failed)} run(s) failed: " + ", ".join(f"{a} seed={s}" for a, s in failed)
            + f" — see the logs under {out}; rerun before collecting")
    return collect(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", choices=sorted(ARMS))
    ap.add_argument("--seed", type=int)
    ap.add_argument("--collect", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--seeds", default=None,
                    help=f"comma-separated seed list for orchestration (default {SEEDS})")
    ap.add_argument("--arms", default=None,
                    help="comma-separated arm subset for orchestration")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=DTYPES)
    ap.add_argument("--backends", default="deterministic", choices=BACKENDS,
                    help="cuDNN deterministic and TF32 off, or PyTorch's defaults")
    ap.add_argument("--out", default=None,
                    help="record folder (default runs/effect_study_torch, bf16: its bfloat16/)")
    args = ap.parse_args(argv)
    args.out = Path(args.out) if args.out else out_dir(args.dtype)
    if args.collect:
        return collect(args.out)
    if args.arm is not None:
        return run_arm(args.arm, args.seed if args.seed is not None else SEEDS[0],
                       device=args.device, dtype=args.dtype, out=args.out,
                       backends=args.backends)
    if args.seed is not None:
        ap.error("--seed only applies with --arm; use --seeds for orchestration")
    return orchestrate(args)


if __name__ == "__main__":
    main()
