#!/usr/bin/env python
"""The self-paced SupCon kernels against float64, on the GPU: this tree's
kernels beside other trees'.

    python3 scripts/measure_supcon_accuracy.py [--parent DIR ...] [--turns N] [--out FILE]

Cases: 2N = 10 (the infonce presets' 5 + 5 views; also with the last slice
of each view padded), 60, 1024 and 3840, D = 256, T = 0.07, weighting
`none`, labels in three partitions, z drawn from a seeded generator in two
kinds:
- `spread`: chip_smoke.py's kernels-phase inputs (a centre per label at
  0.3 plus unit noise, normalised): dot products of different rows near 0;
- `collapsed`: one shared direction plus noise of 0.1 / sqrt(D) a
  coordinate, normalised: every dot product near 1, as for the features of
  an untrained network (the infonce presets' first steps).
Each case runs supcon_fwd and supcon_bwd as the kernel (`*_kernel`), as the
plain float32 version (`*_plain`) and as the plain version in float64, on
the same operands (the backward's per-row statistics are the float64
forward's, rounded to float32). Printed: the largest relative error of
denom over the valid rows, and max|dz - float64| / max|float64 dz|, kernel
and (plain float32); and each kernel's time at 2N = 60, 1024 and 3840 (CUDA
events around 50 calls on the same operands, after 5 warm-up calls).

With --parent DIR (a directory holding another tree's `spcl_torch/`; may be
given more than once) each tree runs in its own process, the others first;
the operands are the same in all. --turns N runs the trees N times, every
other turn in the reverse order; the times printed are each tree's least
over the turns, the errors those of its first turn. The card's name and
power limit are printed beside the numbers.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D = 256
INV_T = 1 / 0.07
CASES = [(n2, kind, pad) for n2, pads in ((10, (0, 1)), (60, (0,)), (1024, (0,)), (3840, (0,)))
         for kind in ("spread", "collapsed") for pad in pads]
TIMED = (60, 1024, 3840)


def _z(n2, kind, gen):
    import torch
    n = n2 // 2
    labels = torch.arange(n, device="cuda") % 3
    if kind == "spread":
        centres = torch.randn(3, D, generator=gen, device="cuda")
        z = torch.cat([centres[labels]] * 2) * 0.3 + torch.randn(n2, D, generator=gen,
                                                                    device="cuda")
    else:
        u = torch.randn(D, generator=gen, device="cuda")
        z = u / u.norm() + torch.randn(n2, D, generator=gen, device="cuda") * (0.1 / D ** 0.5)
    z = torch.nn.functional.normalize(z, dim=1)
    return z[:n].contiguous(), z[n:].contiguous(), labels.int()


def _operands(sc, n2, kind, pad):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(n2 + (kind == "collapsed"))
    z1, z2, labels = _z(n2, kind, gen)
    valid = torch.ones(n2 // 2, device="cuda")
    if pad:
        valid[-pad:] = 0.0
    z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid)
    gid = torch.arange(n_pad, dtype=torch.float32, device="cuda")
    fargs = (z, z, t2, t2, v2, v2, gid, gid, INV_T, 1e9, "none")
    denom, c, _, spsum = sc.fwd_stats_plain(*_f64(fargs))
    a = spsum / torch.clamp(c, min=1.0)
    stats = [x.float() for x in (c, c, denom, denom, a, a)]
    scale = torch.tensor([1.0 / float(v2.sum())], device="cuda")
    bargs = fargs[:8] + tuple(stats) + (INV_T, 1e9, scale, "none")
    return fargs, bargs, v2 > 0


def _f64(args):
    import torch
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                 for a in args)


def _ms(fn, args, reps=50):
    import torch
    for _ in range(5):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def worker(tree):
    """Measure `tree`'s kernels; print one JSON line."""
    sys.path[:0] = [str(Path(tree).resolve())]
    import torch
    from spcl_torch.ops import supcon_cuda as sc
    assert Path(sc.__file__).resolve().is_relative_to(Path(tree).resolve()), sc.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    sc.build()
    out = {}
    for n2, kind, pad in CASES:
        fargs, bargs, rows = _operands(sc, n2, kind, pad)
        den64 = sc.fwd_stats_plain(*_f64(fargs))[0][rows]
        dz64 = sc.bwd_dz_plain(*_f64(bargs))
        case = {}
        for name, f, b in (("kernel", sc.fwd_stats_kernel, sc.bwd_dz_kernel),
                           ("plain", sc.fwd_stats_plain, sc.bwd_dz_plain)):
            den = f(*fargs)[0][rows].double()
            dz = b(*bargs).double()
            case[f"{name} denom"] = float(((den - den64) / den64).abs().max())
            case[f"{name} dz"] = float((dz - dz64).abs().max() / dz64.abs().max())
        if n2 in TIMED and not pad:
            case["fwd ms"] = _ms(sc.fwd_stats_kernel, fargs)
            case["bwd ms"] = _ms(sc.bwd_dz_kernel, bargs)
        out[f"2N={n2} {kind}{' pad' if pad else ''}"] = case
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def _run_tree(tree):
    proc = subprocess.run([sys.executable, __file__, "--tree", str(tree)], capture_output=True,
                          text=True)
    if proc.returncode:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--parent", action="append", default=[],
                    help="a directory holding another tree's spcl_torch/ (repeatable)")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args()
    if args.tree:
        worker(args.tree)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the supcon kernels have no CPU mode")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    trees = [(Path(t).name, t) for t in args.parent] + [("this", ROOT)]
    results = {}
    for turn in range(args.turns):
        for name, tree in (trees if turn % 2 == 0 else trees[::-1]):
            r = _run_tree(tree)
            if name not in results:
                results[name] = r
                continue
            for case, fields in r.items():
                for what, value in fields.items():
                    if what.endswith(" ms"):
                        results[name][case][what] = min(results[name][case][what], value)
    print(f"{smi} | denom: max relative error over valid rows; dz: max|dz - float64| / "
          f"max|float64 dz|; kernel (plain float32); kernel ms, least of {args.turns} turn(s)")
    for case, fields in results["this"].items():
        for what in ("denom", "dz"):
            print(f"  {case:22s} {what:6s} " + " | ".join(
                f"{name} {r[case][f'kernel {what}']:.2e} ({r[case][f'plain {what}']:.2e})"
                for name, r in results.items()), flush=True)
        for what in ("fwd ms", "bwd ms"):
            if what in fields:
                print(f"  {case:22s} {what:6s} " + " | ".join(
                    f"{name} {r[case][what]:.4f}" for name, r in results.items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi, "results": results}, indent=1))


if __name__ == "__main__":
    main()
