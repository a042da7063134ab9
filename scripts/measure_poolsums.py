#!/usr/bin/env python
"""convstage_poolsums on the GPU: this tree's kernel beside another tree's.

    python3 scripts/measure_poolsums.py [--dtype float32|bfloat16] [--parent DIR]
                                        [--out FILE]

For each case (the stage shapes of the pretrain step, B=60: S1 = 224x224x16
and S2 = 112x112x32, and of the fine-tune step, B=5; each with de present
and de absent, dp always present), on seeded random inputs of `--dtype`
(default float32; bfloat16 is `Arch.dtype: bfloat16`'s kernel):
  - the kernel against `poolsums_plain` (chip_smoke.py's STAGE_TOL, 2e-4 x
    max|plain|) and two runs of it bit for bit;
  - `bits`: a sha256 of the sums, which the table compares between trees;
  - `graph_ms`: device time per call, 20 calls captured in one CUDA graph
    and replayed (best of three; chip_smoke.py's `_graph_ms`), without the
    host's time to launch a call;
  - `eager_ms`: 20 calls back to back between CUDA events (`_time_ms`; the
    host's time per call included where it is the longer);
  - the kernels one call launches, by name, with their device time per call
    (torch.profiler over 10 calls, `_profiled`);
  - the byte bound: z1, de and dp read once ((1.25 + de) x px x C x 4 B
    in float32, x 2 B in bfloat16) at 3.35 TB/s.
Where one case's inputs fit in the 50 MB L2 (B=5), the calls cycle through
enough copies of them that each finds its inputs in device memory.

With --parent DIR (a directory holding another tree's `spcl_torch/`, e.g.
`git archive <commit> spcl_torch | tar -x -C DIR`; may be repeated) each
tree runs in its own process, in the turns parent, this, this, parent; the
table keeps each tree's best turn, under the directory's name. Numbers are
the card's own: the card's name and power limit are printed beside them.
"""
import argparse
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 20
CASES = (("S1", 60, 224, 224, 16), ("S2", 60, 112, 112, 32),
         ("S1 B=5", 5, 224, 224, 16), ("S2 B=5", 5, 112, 112, 32))


def worker(tree, dtype_name):
    """Measure `tree`'s poolsums_kernel on `dtype_name` inputs with
    chip_smoke.py's timers (of this tree); print one JSON line."""
    sys.path[:0] = [str(Path(tree).resolve()), str(ROOT)]
    import torch
    import chip_smoke as smoke
    from spcl_torch.ops import convstage_cuda as cs
    assert Path(cs.__file__).resolve().is_relative_to(Path(tree).resolve()), cs.__file__
    cs.build()
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, b, h, w, c in CASES:
        for with_de in (True, False):
            nbytes = (2.25 if with_de else 1.25) * b * h * w * c * dtype.itemsize
            coef = torch.stack([1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
                                0.1 * torch.randn(c, generator=gen, device="cuda")])

            def rn(*shape):
                return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

            sets = [(rn(b, h, w, c), coef.contiguous(), rn(b, h // 2, w // 2, c),
                     rn(b, h, w, c) if with_de else None)
                    for _ in range(max(1, math.ceil(3 * smoke.L2_BYTES / nbytes)))]
            call = smoke._cycling(cs.poolsums_kernel, sets)
            got, again = cs.poolsums_kernel(*sets[0]), cs.poolsums_kernel(*sets[0])
            want = cs.poolsums_plain(*sets[0])
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            key = f"{name} de {'present' if with_de else 'absent'}"
            if err > smoke.STAGE_TOL * scale or not torch.equal(got, again):
                raise SystemExit(f"{key}: kernel differs from plain ({err:.3e} > "
                                 f"{smoke.STAGE_TOL} x {scale:.3e}) or between two runs")
            kernels = smoke._profiled(lambda n: [call() for _ in range(n)], 10)
            results[key] = {
                "graph_ms": smoke._graph_ms(call, REPS), "eager_ms": smoke._time_ms(call, REPS),
                "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
                "copies": len(sets), "max_abs_err": err, "max_abs_plain": scale,
                "bits": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16],
                "kernels": {k[:100]: {"ms_per_call": ms, "per_call": n}
                            for k, (ms, n) in kernels.items()}}
            if hasattr(cs, "poolsums_plan"):
                results[key]["plan"] = cs.poolsums_plan(b, h, w, c, True, with_de, dtype)
            del sets, got, again, want
            torch.cuda.empty_cache()
    print("RESULT " + json.dumps({"tree": str(tree), "cases": results}), flush=True)


def _run_tree(tree, dtype_name):
    proc = subprocess.run([sys.executable, __file__, "--tree", str(tree), "--dtype", dtype_name],
                          capture_output=True, text=True, timeout=600)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])["cases"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--parent", action="append", default=[],
                    help="directory holding another tree's spcl_torch/ (may be repeated)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the activations' storage type (default float32)")
    ap.add_argument("--out", help="write every number as JSON here")
    args = ap.parse_args()
    if args.tree:
        worker(args.tree, args.dtype)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()} | {args.dtype}", flush=True)
    trees = [(Path(d).name, d) for d in args.parent]
    order = trees + [("this", ROOT), ("this", ROOT)] + trees[::-1]
    turns = {}
    for who, tree in order:
        t0 = time.perf_counter()
        turns.setdefault(who, []).append(_run_tree(tree, args.dtype))
        print(f"turn {who}: {time.perf_counter() - t0:.1f} s", flush=True)
    table = {}
    for who, runs in turns.items():
        for key in runs[0]:
            best = {m: min(r[key][m] for r in runs) for m in ("graph_ms", "eager_ms")}
            table.setdefault(key, {})[who] = {
                **runs[0][key], **best,
                "bits": ",".join(sorted({r[key]["bits"] for r in runs})),
                "turns": [(r[key]["graph_ms"], r[key]["eager_ms"]) for r in runs]}
    for key, row in table.items():
        bits = {r["bits"] for r in row.values()}
        print(f"{key}: bound {row['this']['bound_ms']:.4f} ms (bytes) | sums "
              + ("the same bits in every tree" if len(bits) == 1 else
                 "differ between trees: " + ", ".join(f"{w} {r['bits']}"
                                                     for w, r in row.items())), flush=True)
        for who, r in row.items():
            names = "; ".join(f"x{v['per_call']:.0f} {v['ms_per_call']:.4f} ms {k[:56]}"
                              for k, v in r["kernels"].items())
            print(f"  {who:10s} graph {r['graph_ms']:.4f} ms "
                  f"({100 * r['bound_ms'] / r['graph_ms']:.0f}% of bound) | eager "
                  f"{r['eager_ms']:.4f} ms | err {r['max_abs_err']:.2e} / "
                  f"{r['max_abs_plain']:.2e} | {r.get('plan', '')} | {names}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi.strip(), "dtype": args.dtype,
                                              "cases": table}, indent=1))


if __name__ == "__main__":
    main()
