#!/usr/bin/env python
"""Where the supcon kernels spend a column tile, on the GPU.

    python3 scripts/measure_supcon_phases.py [--shape 3840x3840] [--power]

Builds copies of `spcl_torch/ops/csrc/supcon.cu` into `build/spcl_torch/phases/`
with `clock64()` marks in the column sweep (thread 0 of every block), and
prints, for supcon_fwd and supcon_bwd at the shape (rows x cols, D = 256, rows
the first entries of the columns), the device time per call (CUDA-graph
replay) and the mean cycles per block and per column tile spent in each
phase:
  wait      for the tile's copy and the block barrier;
  issue     the copy of a later tile (and, on the first tile, the A fragments);
  mma       this warp's share of the s product (3xTF32 MMAs);
  barrier   until every warp's share is in;
  epilogue  the forward's per-row sums; the backward's G @ z product;
  G         (backward) the G tile and its barrier;
  tail      the cluster sums after the sweep.
Variants change one thing in the copy of each column tile:
  base          the source as it is;
  no_copy       only the first tile is copied (later tiles compute on stale
                data): the sweep without its copies;
  quarter_rows  each tile copies 8 of its 32 rows: a quarter of the traffic;
  one_warp      warp 0 issues all 32 row copies (lanes 0-3 of every warp
                in the source);
  three_stages  a ring of three column-tile buffers (two in the source), so
                that each copy is issued two tiles ahead.
--power samples the SM clock and the power draw (nvidia-smi, every 50 ms)
while each kernel and the float32 torch.mm of its product replay for 1.5 s.
Numbers are the card's own; print its name and power limit beside them.
"""
import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from spcl_torch.ops import _build  # noqa: E402
from spcl_torch.ops import supcon_cuda as sc  # noqa: E402

MARKS = r'''#include <stdint.h>
__device__ unsigned long long g_phase[8192][8];
__device__ __forceinline__ void mark(int i) {
  if (threadIdx.x == 0) {
    const unsigned long long now = clock64();
    unsigned long long* p = g_phase[(blockIdx.y * gridDim.x + blockIdx.x) & 8191];
    p[i] += now - p[7];
    p[7] = now;
  }
}
__device__ __forceinline__ void mark_start() {
  if (threadIdx.x == 0) g_phase[(blockIdx.y * gridDim.x + blockIdx.x) & 8191][7] = clock64();
}
extern "C" int phase_reset() {
  static unsigned long long zero[8192][8];
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 8192 * 8);
}
'''
PHASES = ("wait", "issue", "mma", "barrier", "epilogue", "tail", "G")
# (text in the source, text with its mark): the same marks in every variant
MARK_EDITS = [
    ("#include <stdint.h>", MARKS),
    ("    __syncthreads();  // tile i landed; every reader of tile i - 1 is done\n",
     "    __syncthreads();  // tile i landed; every reader of tile i - 1 is done\n    mark(0);\n"),
    ("    if (i == first) hook();\n", "    if (i == first) hook();\n    mark(1);\n"),
    ("          s_partial(a, ct, part);\n          __syncthreads();  // the partials are complete;",
     "          s_partial(a, ct, part);\n          mark(2);\n          __syncthreads();  // the partials are complete;"),
    ("          s_sum(part, er, ec, s);\n          vec8(cv + ec, lab);\n          vec8(cv + BN + ec, val);\n"
     "          vec8(cv + 2 * BN + ec, gid);\n          const bool keep_it",
     "          mark(3);\n          s_sum(part, er, ec, s);\n          vec8(cv + ec, lab);\n"
     "          vec8(cv + BN + ec, val);\n          vec8(cv + 2 * BN + ec, gid);\n          const bool keep_it"),
    ("          if (keep_it && tid < NVEC_FWD * BN) kt[BM * BN + tid] = cv[tid];\n        });",
     "          if (keep_it && tid < NVEC_FWD * BN) kt[BM * BN + tid] = cv[tid];\n          mark(4);\n        });"),
    ("          s_partial(a, ct, part);\n          __syncthreads();  // the partials and the column terms",
     "          s_partial(a, ct, part);\n          mark(2);\n          __syncthreads();  // the partials and the column terms"),
    ("          float s[8], lab[8], val[8], gid[8], cc[8], ac[8]",
     "          mark(3);\n          float s[8], lab[8], val[8], gid[8], cc[8], ac[8]"),
    ("          __syncthreads();  // the G tile is complete\n          gz_tile(gt, ct, acc);\n",
     "          __syncthreads();  // the G tile is complete\n          mark(6);\n          gz_tile(gt, ct, acc);\n"
     "          mark(4);\n"),
    ("  ring_init(R, d);\n  issue_rows(smem + F_KEEP", "  ring_init(R, d);\n  mark_start();\n  issue_rows(smem + F_KEEP"),
    ("  ring_init(R, d);\n  issue_rows(rt,", "  ring_init(R, d);\n  mark_start();\n  issue_rows(rt,"),
    ("  cluster.sync();  // no block leaves while rank 0 reads its partials",
     "  mark(5);\n  cluster.sync();  // no block leaves while rank 0 reads its partials"),
    ("  cluster.sync();  // no block leaves while another reads its partial",
     "  mark(5);\n  cluster.sync();  // no block leaves while another reads its partial"),
]
ISSUE = '''  if (threadIdx.x == 0) mbar_expect_tx(&R.bar[j], BN * d * 4);
  if ((threadIdx.x & 31) < BN / NWARP) {
    const int r = (threadIdx.x >> 5) * (BN / NWARP) + (threadIdx.x & 31);
    bulk_copy(st + z_at(r, 0), C.z + (size_t)(tile * BN + r) * d, d * 4, &R.bar[j]);
  }'''
VARIANTS = {
    "base": [],
    "no_copy": [("    if (ahead < last) issue_tile(R, (ahead - first) % NSTAGE, C, ahead, d);",
                 "    if (ahead < last && ahead < first + NSTAGE) issue_tile(R, (ahead - first) % NSTAGE, C, ahead, d);\n"
                 "    else if (ahead < last && threadIdx.x == 0) mbar_expect_tx(&R.bar[(ahead - first) % NSTAGE], 0);")],
    "quarter_rows": [(ISSUE, ISSUE.replace("BN * d * 4", "BN / 4 * d * 4")
                      .replace("< BN / NWARP", "< BN / 4 / NWARP").replace("* (BN / NWARP)", "* (BN / 4 / NWARP)"))],
    "three_stages": [("constexpr int NSTAGE = 2;", "constexpr int NSTAGE = 3;")],
    "one_warp": [(ISSUE, '''  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) mbar_expect_tx(&R.bar[j], BN * d * 4);
    __syncwarp();
    bulk_copy(st + z_at(threadIdx.x, 0), C.z + (size_t)(tile * BN + threadIdx.x) * d, d * 4, &R.bar[j]);
  }''')],
}
OUT = _build.BUILD_DIR / "phases"


def build(name):
    src = sc.SOURCE.read_text()
    for old, new in MARK_EDITS + VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, so


def operands(rows, cols):
    """Rows = the first `rows` columns; z L2-normalized, labels in 3
    partitions, the statistics of the backward from the plain forward."""
    g = torch.Generator(device="cuda").manual_seed(0)
    zc = torch.nn.functional.normalize(torch.randn(cols, 256, generator=g, device="cuda"), dim=1)
    lab = (torch.arange(cols, device="cuda") % 3).float()
    val = torch.ones(cols, device="cuda")
    gid = torch.arange(cols, dtype=torch.float32, device="cuda")
    ops = (zc[:rows].contiguous(), zc, lab[:rows].contiguous(), lab, val[:rows].contiguous(), val,
           gid[:rows].contiguous(), gid)
    den, c, _, sps = sc.fwd_stats_plain(zc, zc, lab, lab, val, val, gid, gid, 1 / 0.07, 3.0, "hard")
    a = sps / torch.clamp(c, min=1.0)
    return ops, (c[:rows].contiguous(), c, den[:rows].contiguous(), den, a[:rows].contiguous(), a)


def graph(fn, reps):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return g


def graph_ms(fn, reps=20):
    g = graph(fn, reps)
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def sampled(name, fn, reps=20, seconds=1.5):
    """Replay `fn` for `seconds` while nvidia-smi samples clock and power."""
    g = graph(fn, reps)
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    calls, t0 = 0, time.time()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    while time.time() - t0 < seconds:
        g.replay()
        calls += reps
        if calls % (10 * reps) == 0:
            torch.cuda.synchronize()
    end.record()
    torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].strip().splitlines()]
    clock = sorted(float(r[0]) for r in rows if len(r) == 2)
    power = sorted(float(r[1]) for r in rows if len(r) == 2)
    print(f"{name}: {start.elapsed_time(end) / calls:.4f} ms a call over {calls} calls | SM clock "
          f"MHz min {clock[0]:.0f} median {clock[len(clock) // 2]:.0f} | power W median "
          f"{power[len(power) // 2]:.0f} max {power[-1]:.0f} ({len(rows)} samples)", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", default="3840x3840")
    parser.add_argument("--variants", default="base,no_copy,quarter_rows,three_stages,one_warp")
    parser.add_argument("--power", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rows, cols = (int(x) for x in args.shape.split("x"))
    torch.backends.cuda.matmul.allow_tf32 = False
    ops, stats = operands(rows, cols)
    scale = torch.full((1,), 1e-3, device="cuda")
    calls = {"supcon_fwd": lambda: sc.fwd_stats_kernel(*ops, 1 / 0.07, 3.0, "hard"),
             "supcon_bwd": lambda: sc.bwd_dz_kernel(*ops, *stats, 1 / 0.07, 3.0, scale, "hard")}
    names = args.variants.split(",")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    for name, so in built:
        lib = sc.bind(so)
        lib.phase_reset.restype = ctypes.c_int
        lib.phase_read.argtypes = [ctypes.c_void_p]
        sc._lib = lib
        for kernel, fn in calls.items():
            ms = graph_ms(fn)
            lib.phase_reset()
            fn()
            torch.cuda.synchronize()
            buf = np.zeros((8192, 8), dtype=np.uint64)
            lib.phase_read(buf.ctypes.data)
            plan = sc.plan(kernel, rows, cols, 256)
            per_block = buf[:plan["cluster"] * plan["row_tiles"], :7].astype(np.float64).mean(axis=0)
            tiles = max(plan["tiles_per_block"], 1)
            print(f"{name} {kernel} {rows}x{cols}: {ms:.4f} ms (cluster {plan['cluster']}, "
                  f"{tiles} tiles a block) | cycles a tile: "
                  + ", ".join(f"{p} {v / tiles:.0f}" for p, v in zip(PHASES, per_block)
                              if p != "tail")
                  + f" | tail {per_block[5]:.0f} a block", flush=True)
    if args.power:
        sc._lib = None
        for kernel, fn in calls.items():
            sampled(f"{kernel} {rows}x{cols}", fn)
        sampled(f"torch.mm {rows}x{cols}", lambda: torch.mm(ops[0], ops[1].T))


if __name__ == "__main__":
    main()
