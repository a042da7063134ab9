#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`spcl_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. device  — refuse to run without CUDA; print the card's name and power
               limit (nvidia-smi).
  2. build   — compile spcl_torch/ops/csrc/supcon.cu and convstage.cu with
               nvcc for sm_90a, one nvcc per source, started together.
  3. kernels — hold the supcon kernels against their plain PyTorch versions
               (float32, TF32 off) at 2N in {60, 126, 1024, 3840}, D=256,
               in every weighting mode, correct_grad on and off, and with
               padded (valid=0) rows; hold the seven stage kernels against
               theirs at the main path's two shapes (B=60: 224^2 x C16 fed by
               an ordinary first convolution, 112^2 x C16->32) and at a small
               odd-batch shape, with random dp and random non-zero de: the
               forward and the backward as wholes, each pass alone, and two
               runs bit for bit; time kernel vs plain with CUDA events.
  4. slice A — the encoder-pretrain path of main_pretrain_encoder.py at the
               paper's configuration (UNet max_channel=256 to Conv5, crop
               224 of a 256 canvas, 2N=60, self-paced SupCon hard 3->14,
               RAdam, `small_c_layout: nhwc`) on synthetic data: 1 epoch x 5
               steps through spcl_torch.entry.build_trainer; checks the
               kernel launch counts, finite losses, sp_weight in [0, 1],
               gamma following PScheduler, and a last.ckpt that reloads
               strictly.
  5. slice B — both phases of main_pretrain_encoder.py under
               `small_c_layout: pallas` at the same width: 5 pretrain steps
               at 2N=60, then `val()` over one labeled ratio — 1 epoch x 5
               fine-tune steps of the whole UNet and one eval epoch on the
               val and test loaders, warm-started from the pretrain
               last.ckpt; checks the stage kernels' launch counts per step
               (none during eval), finite losses, a DSC in [0, 1], and a
               best.ckpt that reloads strictly into a plain UNet.
  6. profile — the pretrain step under `pallas` beside `nhwc`: 20 timed
               steps each (twice, in turns), 5 under torch.profiler (kernel
               time by kernel, the stage kernels' share); and the two
               stages alone, forward + backward, fused beside cuDNN.
  7. parity  — one small pretrain step, and one small fine-tune step under
               `pallas`, on the card (kernels) against the same step on the
               CPU (plain versions) from the same weights and draws.
  8. report  — the `kernels` JSON line, the nvidia-smi line, a device line
               with the slice's throughput, and last
               {"ok": true, "device": {...}}.
"""
import copy
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# bytes/s and float32 FLOP/s (no tensor cores) of one H100 SXM (data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SIZES = (60, 126, 1024, 3840)          # checked against the plain versions
TIMING_SIZES = (60, 126, 256, 512, 1024, 3840)
D = 256
MAIN_2N = 60
DEVICE = "cuda"

# base.yaml + pretrain.yaml + specific/selfpaced_infonce.yaml, with
# Data.synthetic, max_epoch 1 and num_batches 5 (the port runs without pyyaml)
CONFIG = {
    "RandomSeed": 10,
    "Arch": {"input_dim": 1, "num_classes": 4, "checkpoint": None, "max_channel": 256,
             "momentum": 0.1, "dtype": "float32", "small_c_layout": "nhwc"},
    "Optim": {"name": "RAdam", "lr": 1e-7, "weight_decay": 1e-5},
    "Scheduler": {"multiplier": 400, "warmup_max": 10},
    "Data": {"name": "acdc", "labeled_scan_num": 1, "canvas": 256, "crop": 224,
             "synthetic": True, "synthetic_scans": 20, "synthetic_test_scans": 8,
             "root": None},
    "LabeledLoader": {"batch_size": 5},
    "UnlabeledLoader": {"batch_size": 5},
    "Trainer": {"save_dir": "runs/chip_smoke", "num_batches": 5, "max_epoch": 1,
                "name": "pretrain_encoder", "save_every": 1},
    "ContrastiveLoaderParams": {"scan_sample_num": 10, "partition_sample_num": 1},
    "SPInfonceParams": {"feature_names": "Conv5", "weights": 0.1,
                        "contrast_ons": "partition", "temperature": 0.07,
                        "begin_values": 3, "end_values": 14, "p": 0.5, "mode": "hard"},
}


# views per step: 2 x scan_sample_num x 3 ACDC partitions x partition_sample_num
VIEWS = 2 * 3 * CONFIG["ContrastiveLoaderParams"]["scan_sample_num"] \
    * CONFIG["ContrastiveLoaderParams"]["partition_sample_num"]


def phase(name):
    print(f"== {name}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def device_phase():
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this script runs only on the GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return smi


def build_phase(*modules):
    """One nvcc per source, all started together."""
    phase("build")
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        results = list(pool.map(lambda m: m.build(verbose=True), modules))
    for path, seconds, log in results:
        print(f"built {path.relative_to(ROOT)} in {seconds:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip(), flush=True)
    print(f"build wall time {time.perf_counter() - t0:.2f} s", flush=True)


# ------------------------------------------------------------------ kernels
def _inputs(n2, gen, pad_rows=0):
    """z [2N, D] L2-normalized with label-correlated structure, labels in 3
    partitions (as the batch sampler gives them), valid with `pad_rows`
    zeros at the end of each view."""
    n = n2 // 2
    labels = torch.arange(n, device=DEVICE) % 3
    centers = torch.randn(3, D, generator=gen, device=DEVICE)
    z = torch.cat([centers[labels], centers[labels]]) * 0.3 \
        + torch.randn(n2, D, generator=gen, device=DEVICE)
    z = torch.nn.functional.normalize(z, dim=1)
    valid = torch.ones(n, device=DEVICE)
    if pad_rows:
        valid[-pad_rows:] = 0.0
    return z[:n].contiguous(), z[n:].contiguous(), labels.int(), valid


def _hard_gamma(sc, z1, z2, labels, valid):
    """A hard-mode gamma inside the spread of the pair losses but away from
    ties: the midpoint of the widest gap among the top 1% of the positive
    pairs' -logp (plain computation)."""
    z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid)
    gid = torch.arange(n_pad, dtype=torch.float32, device=DEVICE)
    s, p, e = sc._pair_terms(z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07)
    nll = -(s - torch.log(e.sum(1) + sc._EPS)[:, None])
    vals = torch.sort(nll[p > 0]).values
    top = vals[min(int(0.99 * (len(vals) - 1)), len(vals) - 3):]
    k = int(torch.argmax(top[1:] - top[:-1]))
    return float((top[k] + top[k + 1]) / 2), float(top[k + 1] - top[k])


def _stats_and_dz(sc, use_kernel, z1, z2, labels, valid, gamma, mode, correct_grad):
    """(loss, ratio, per-row stats, dz1, dz2) through the autograd Function,
    on the kernels or on the plain versions."""
    saved = (sc.fwd_stats_kernel, sc.bwd_dz_kernel)
    if not use_kernel:
        sc.fwd_stats_kernel, sc.bwd_dz_kernel = sc.fwd_stats_plain, sc.bwd_dz_plain
    try:
        a = z1.clone().requires_grad_(True)
        b = z2.clone().requires_grad_(True)
        loss, ratio = sc.FusedSupCon.apply(a, b, labels, valid, gamma, 1 / 0.07, mode,
                                           correct_grad)
        loss.backward()
        z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid)
        gid = torch.arange(n_pad, dtype=torch.float32, device=DEVICE)
        stats = sc.fwd_stats(z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07, gamma, mode)
        torch.cuda.synchronize()
        return loss.detach(), ratio, stats, a.grad, b.grad
    finally:
        sc.fwd_stats_kernel, sc.bwd_dz_kernel = saved


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_pair(sc, n2, gen):
    """kernel and plain times (ms) of the forward stats and of dz at 2N=n2."""
    z1, z2, labels, valid = _inputs(n2, gen)
    z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid)
    gid = torch.arange(n_pad, dtype=torch.float32, device=DEVICE)
    inv_t, gamma = 1 / 0.07, 3.0
    fargs = (z, z, t2, t2, v2, v2, gid, gid, inv_t, gamma, "hard")
    _, c, denom, a, _ = sc.fwd_stats(*fargs)
    scale = torch.full((1,), 1.0 / n2, device=DEVICE)
    bargs = (z, z, t2, t2, v2, v2, gid, gid, c, c, denom, denom, a, a, inv_t, gamma,
             scale, "hard")
    reps = 200 if n2 <= 1024 else 20
    out = {}
    # turns: plain, kernel, kernel, plain
    p1 = _time_ms(lambda: sc.fwd_stats_plain(*fargs), reps)
    k1 = _time_ms(lambda: sc.fwd_stats_kernel(*fargs), reps)
    k2 = _time_ms(lambda: sc.fwd_stats_kernel(*fargs), reps)
    p2 = _time_ms(lambda: sc.fwd_stats_plain(*fargs), reps)
    out["supcon_fwd"] = (min(k1, k2), min(p1, p2))
    p1 = _time_ms(lambda: sc.bwd_dz_plain(*bargs), reps)
    k1 = _time_ms(lambda: sc.bwd_dz_kernel(*bargs), reps)
    k2 = _time_ms(lambda: sc.bwd_dz_kernel(*bargs), reps)
    p2 = _time_ms(lambda: sc.bwd_dz_plain(*bargs), reps)
    out["supcon_bwd"] = (min(k1, k2), min(p1, p2))
    return out


def _bound_ms(n2):
    """Least time for the work at 2N=n2, D=256 on the H100: the larger of
    bytes / HBM rate and float32 operations / float32 peak. Bytes: z read
    once, 3 [2N] row vectors read, outputs written once. Operations: the
    forward needs one [2N, D] x [D, 2N] product (2 * 2N^2 * D FLOPs); the
    backward the product for s and G @ z (4 * 2N^2 * D)."""
    z_bytes = n2 * D * 4
    vec = n2 * 4
    fwd = max((z_bytes + 3 * vec + 4 * vec) / HBM_BYTES_PER_S,
              2.0 * n2 * n2 * D / F32_FLOPS)
    bwd = max((z_bytes + 3 * vec + 6 * vec + z_bytes) / HBM_BYTES_PER_S,
              4.0 * n2 * n2 * D / F32_FLOPS)
    bound_by = {"supcon_fwd": "operations" if 2.0 * n2 * n2 * D / F32_FLOPS
                > (z_bytes + 7 * vec) / HBM_BYTES_PER_S else "bytes",
                "supcon_bwd": "operations" if 4.0 * n2 * n2 * D / F32_FLOPS
                > (2 * z_bytes + 9 * vec) / HBM_BYTES_PER_S else "bytes"}
    return {"supcon_fwd": fwd * 1e3, "supcon_bwd": bwd * 1e3}, bound_by


def kernel_phase(sc):
    phase("kernels vs plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    max_err = {"supcon_fwd": 0.0, "supcon_bwd": 0.0}
    cases = 0
    for n2 in SIZES:
        for pad_rows in ((0, 5) if n2 == 126 else (0,)):
            z1, z2, labels, valid = _inputs(n2, gen, pad_rows)
            hard_gamma, gap = _hard_gamma(sc, z1, z2, labels, valid)
            for mode, correct_grad in (("none", False), ("soft", False), ("soft", True),
                                       ("hard", False), ("hard", True)):
                gamma = {"none": 1e9, "soft": 8.0, "hard": hard_gamma}[mode]
                k = _stats_and_dz(sc, True, z1, z2, labels, valid, gamma, mode, correct_grad)
                p = _stats_and_dz(sc, False, z1, z2, labels, valid, gamma, mode, correct_grad)
                # per-row stats: rowloss, c, log(denom), a — all O(1..10)
                fwd_err = max(float((k[2][0] - p[2][0]).abs().max()),
                              float((k[2][1] - p[2][1]).abs().max()),
                              float((torch.log(k[2][2] + 1e-16)
                                     - torch.log(p[2][2] + 1e-16)).abs().max()),
                              float((k[2][3] - p[2][3]).abs().max()))
                dz_scale = float(torch.cat([p[3], p[4]]).abs().max())
                dz_err = float(torch.cat([k[3] - p[3], k[4] - p[4]]).abs().max())
                loss_err = abs(float(k[0]) - float(p[0]))
                ratio_err = abs(float(k[1]) - float(p[1]))
                # tolerances: float32 sums in another order over D=256 and 2N
                # columns; s carries 1/T = 14.3x the dot-product rounding
                tol_fwd = 2e-4
                tol_dz = 2e-4 * dz_scale
                ok = (fwd_err <= tol_fwd and dz_err <= tol_dz
                      and loss_err <= 2e-4 * max(1.0, abs(float(p[0])))
                      and ratio_err <= 1e-5)
                print(f"2N={n2:5d} pad={pad_rows} {mode:4s} cg={int(correct_grad)} "
                      f"gamma={gamma:.6g}{f' (gap {gap:.2e})' if mode == 'hard' else ''} "
                      f"loss={float(p[0]):.6f} ratio={float(p[1]):.4f} | err: "
                      f"stats {fwd_err:.2e} dz {dz_err:.2e} (scale {dz_scale:.2e}) "
                      f"loss {loss_err:.2e} ratio {ratio_err:.2e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"kernel disagrees with plain at 2N={n2} {mode} cg={correct_grad}")
                max_err["supcon_fwd"] = max(max_err["supcon_fwd"], fwd_err)
                max_err["supcon_bwd"] = max(max_err["supcon_bwd"], dz_err)
                cases += 1
    print(f"{cases} cases agree (stats tol 2e-4 abs; dz tol 2e-4 x max|dz|)", flush=True)

    timings = {}
    for n2 in TIMING_SIZES:
        t = _time_pair(sc, n2, gen)
        bound, bound_by = _bound_ms(n2)
        timings[n2] = {name: {"ms": t[name][0], "plain_ms": t[name][1],
                              "bound_ms": bound[name], "bound_by": bound_by[name]}
                       for name in t}
        for name, v in timings[n2].items():
            print(f"time 2N={n2:5d} {name}: kernel {v['ms']:.4f} ms | plain "
                  f"{v['plain_ms']:.4f} ms | bound {v['bound_ms']:.6f} ms "
                  f"({v['bound_by']})", flush=True)
    print("timings " + json.dumps({str(k): v for k, v in timings.items()}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults again
    torch.backends.cudnn.allow_tf32 = True
    return max_err, timings


# ------------------------------------------------------------------ stage kernels
# (name, B, H, W, Ci, C, external_first): the two shapes of the main path at
# 2N = 60, and a small odd-batch shape whose H and W are no tile multiples
STAGE_SHAPES = (
    ("stage1", 60, 224, 224, 16, 16, True),
    ("stage2", 60, 112, 112, 16, 32, False),
    ("small-ext", 3, 20, 36, 16, 16, True),
    ("small", 3, 20, 36, 16, 32, False),
)
STAGE_TOL = 2e-4  # x max|plain value| of each tensor
STAGE_REPLACES = {
    "conv": "spcl_tpu/experimental/packed_block_pallas.py:245 _k_conv",
    "bnconv": "spcl_tpu/experimental/packed_block_pallas.py:283 _k_bnconv",
    "bnpool": "spcl_tpu/experimental/packed_block_pallas.py:315 _k_bnpool",
    "poolsums": "spcl_tpu/experimental/packed_block_pallas.py:346 _k_poolsums",
    "dz1": "spcl_tpu/experimental/packed_block_pallas.py:374 _k_dz1",
    "dwprev": "spcl_tpu/experimental/packed_block_pallas.py:412 _k_dwprev",
    "dwdx": "spcl_tpu/experimental/packed_block_pallas.py:471 _k_dwdx",
}


def _stage_inputs(gen, b, h, w, ci, c, external_first):
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=DEVICE) * scale

    x = rn(b, h, w, c if external_first else ci)
    w0 = None if external_first else rn(3, 3, ci, c, scale=(9 * ci) ** -0.5)
    w1 = rn(3, 3, c, c, scale=(9 * c) ** -0.5)
    args = (x, w0, 1 + rn(c, scale=0.1), rn(c, scale=0.1), w1,
            1 + rn(c, scale=0.1), rn(c, scale=0.1))
    return args, rn(b, h // 2, w // 2, c), rn(b, h, w, c)


def _hold(what, names, kernel_out, plain_out):
    """Every tensor of `kernel_out` against `plain_out` within STAGE_TOL x
    max|plain|. Returns the largest absolute error."""
    worst, parts, bad = 0.0, [], []
    for name, k, p in zip(names, kernel_out, plain_out):
        if p is None:
            check(k is None, f"{what}: {name} should be None")
            continue
        check(k.shape == p.shape, f"{what}: {name} shape {k.shape} vs {p.shape}")
        check(bool(torch.isfinite(k).all()), f"{what}: {name} not finite")
        scale = max(float(p.abs().max()), 1e-12)
        err = float((k.double() - p.double()).abs().max())
        parts.append(f"{name} {err:.1e}/{scale:.1e}")
        if err > STAGE_TOL * scale:
            n_bad = int(((k.double() - p.double()).abs() > STAGE_TOL * scale).sum())
            bad.append(f"{name}: {err:.3e} > {STAGE_TOL} x {scale:.3e} at {n_bad} of "
                       f"{k.numel()} elements")
        worst = max(worst, err)
    print(f"  {what}: " + " | ".join(parts) + " (abs err / max|plain|) "
          + ("FAIL" if bad else "ok"), flush=True)
    check(not bad, f"{what} differs from plain: " + "; ".join(bad))
    return worst


def _stage_bounds(b, h, w, ci, c):
    """Least ms for each pass on the H100: the larger of the bytes it must
    move (each input read once, each output written once) over the memory
    rate and its float32 operations over the float32 peak."""
    px, f = b * h * w, 4

    def conv_flops(i, o):
        return 2.0 * 9 * i * o * px

    bytes_ = {"conv": px * (ci + c) * f + 9 * ci * c * f,
              "bnconv": px * 2 * c * f + 9 * c * c * f,
              "bnpool": px * c * f * 2.25,              # z1 -> e, p
              "poolsums": px * c * f * 2.25,            # z1, de, dp
              "dz1": px * c * f * 3.25,                 # z1, de, dp -> dz1
              "dwprev": px * c * f * 3 + 2 * 9 * c * c * f,   # dz1, z0 -> dy0, dW1
              "dwdx": px * f * (2 * c + 2 * ci) + 2 * 9 * ci * c * f}  # z0, dy0, x -> dx, dW0
    flops = {"conv": conv_flops(ci, c), "bnconv": conv_flops(c, c) + 3.0 * px * c,
             "bnpool": 4.0 * px * c, "poolsums": 9.0 * px * c, "dz1": 11.0 * px * c,
             "dwprev": 2 * conv_flops(c, c) + 4.0 * px * c,
             "dwdx": 2 * conv_flops(ci, c) + 4.0 * px * c}
    out = {}
    for name in bytes_:
        tb, tf = bytes_[name] / HBM_BYTES_PER_S, flops[name] / F32_FLOPS
        out[name] = {"bound_ms": max(tb, tf) * 1e3,
                     "bound_by": "operations" if tf > tb else "bytes"}
    return out


def _best_of_turns(kernel_fn, plain_fn, reps):
    """min over the turns plain, kernel, kernel, plain (ms)."""
    p1 = _time_ms(plain_fn, reps)
    k1 = _time_ms(kernel_fn, reps)
    k2 = _time_ms(kernel_fn, reps)
    p2 = _time_ms(plain_fn, reps)
    return min(k1, k2), min(p1, p2)


def stage_kernel_phase(cs):
    """Hold the stage kernels against their plain versions: the forward as a
    whole, the backward as a whole from the same residuals (random dp and
    random non-zero de, and de absent as on the pretrain path), each pass
    alone on the same inputs, and two runs bit for bit; then time each pass
    at the path's two shapes."""
    phase("stage kernels vs plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    results = {name: {"max_abs_err": 0.0, "shapes": {}} for name in cs.PASSES}
    fwd_names = ("p", "e", "mean0", "var0", "mean1", "var1")
    for shape_name, b, h, w, ci, c, ext in STAGE_SHAPES:
        print(f"{shape_name}: B={b} {h}x{w} C {'(z0) ' if ext else f'{ci}->'}{c} "
              f"external_first={ext}", flush=True)
        args, dp, de = _stage_inputs(gen, b, h, w, ci, c, ext)
        check(float(de.abs().max()) > 0 and float(dp.abs().max()) > 0, "zero cotangents")
        bwd_names = ("dz0" if ext else "dx", "dW0", "dgamma0", "dbeta0", "dW1", "dgamma1",
                     "dbeta1")
        out_k, res = cs.stage_forward(*args, ext)
        out_p, _ = cs.stage_forward(*args, ext, plain=True)
        _hold("forward", fwd_names, out_k, out_p)
        bwd_k = cs.stage_backward(res, dp, de, ext)
        _hold(f"backward (max|de| {float(de.abs().max()):.2f})", bwd_names, bwd_k,
              cs.stage_backward(res, dp, de, ext, plain=True))
        _hold("backward, de absent", bwd_names, cs.stage_backward(res, dp, None, ext),
              cs.stage_backward(res, dp, None, ext, plain=True))
        # two runs of the same inputs: fixed-order reductions give the same bits
        out_2, res_2 = cs.stage_forward(*args, ext)
        bwd_2 = cs.stage_backward(res_2, dp, de, ext)
        same = all(torch.equal(a, b2) for a, b2 in zip(out_k + bwd_k, out_2 + bwd_2)
                   if a is not None)
        check(same, f"{shape_name}: two runs of the same inputs differ")
        print("  two runs bit for bit: equal", flush=True)
        del out_2, res_2, bwd_2, out_p

        # each pass alone, kernel and plain on the same inputs
        x, z0, z1, w0, w1, g0, g1, mean0, var0, coef0, mean1, var1, coef1 = res
        n = b * h * w
        dcoef1, _, _ = cs.bn_bwd_coef(cs.poolsums_kernel(z1, coef1, dp, de), n, mean1, var1, g1)
        dz1 = cs.dz1_kernel(z1, coef1, dcoef1, dp, de)
        dy0, _, sums_dy0 = cs.dwprev_kernel(dz1, z0, coef0, w1)
        dcoef0, _, _ = cs.bn_bwd_coef(sums_dy0, n, mean0, var0, g0)
        pass_inputs = {"bnconv": (z0, coef0, w1), "bnpool": (z1, coef1),
                       "poolsums": (z1, coef1, dp, de), "dz1": (z1, coef1, dcoef1, dp, de),
                       "dwprev": (dz1, z0, coef0, w1)}
        if not ext:
            pass_inputs.update({"conv": (x, w0), "dwdx": (z0, dy0, dcoef0, x, w0)})
        out_names = {"conv": ("z0", "sums"), "bnconv": ("z1", "sums"), "bnpool": ("e", "p"),
                     "poolsums": ("sums",), "dz1": ("dz1",), "dwprev": ("dy0", "dW1", "sums"),
                     "dwdx": ("dx", "dW0")}
        bounds = _stage_bounds(b, h, w, ci, c)
        for name in cs.PASSES:
            if name not in pass_inputs:
                continue
            inputs = pass_inputs[name]
            kernel_fn, plain_fn = cs._KERNEL_PASSES[name], cs._PLAIN_PASSES[name]
            k_out, p_out = kernel_fn(*inputs), plain_fn(*inputs)
            if torch.is_tensor(k_out):
                k_out, p_out = (k_out,), (p_out,)
            err = _hold(f"pass {name}", out_names[name], k_out, p_out)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            del k_out, p_out
            if not shape_name.startswith("stage"):
                continue
            ms, plain_ms = _best_of_turns(lambda: kernel_fn(*inputs),
                                          lambda: plain_fn(*inputs), 5)
            results[name]["shapes"][shape_name] = {
                "at": f"B={b} {h}x{w} C={'' if ext else f'{ci}->'}{c}", "ms": ms,
                "plain_ms": plain_ms, **bounds[name]}
            print(f"  time {name}: kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | bound "
                  f"{bounds[name]['bound_ms']:.3f} ms ({bounds[name]['bound_by']})", flush=True)
            if name == "conv":
                # one library call computes this pass's convolution (not its sums)
                xc, wc = x.permute(0, 3, 1, 2), w0.permute(3, 2, 0, 1).contiguous()
                results[name]["library_ms"] = _time_ms(
                    lambda: torch.nn.functional.conv2d(xc, wc, padding=1), 5)
                print(f"  time {name}: library F.conv2d (float32, channels-last input) "
                      f"{results[name]['library_ms']:.3f} ms", flush=True)
        del res, bwd_k, out_k, dz1, dy0, args, dp, de
        torch.cuda.empty_cache()
    print("stage_timings " + json.dumps(results), flush=True)
    torch.backends.cudnn.allow_tf32 = True
    return results


# ------------------------------------------------------------------ slice
def slice_phase(sc):
    phase("slice A: encoder pretrain, UNet-256, 224^2, 2N=60, small_c_layout nhwc")
    from spcl_torch.entry import build_trainer
    from spcl_torch.models import UNet
    from spcl_torch.schedulers import PScheduler
    from spcl_torch.training import load_model_state_dict

    save_dir = ROOT / CONFIG["Trainer"]["save_dir"]
    shutil.rmtree(save_dir, ignore_errors=True)
    trainer = build_trainer(CONFIG, save_dir=str(save_dir), pretrain=True, device=DEVICE)
    check(trainer._forward_until == "Conv5", trainer._forward_until)
    trainer.init()
    steps = CONFIG["Trainer"]["max_epoch"] * CONFIG["Trainer"]["num_batches"]
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.start_training()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sc.LAUNCHES)
    print(f"launches in {steps} steps: {launches}", flush=True)
    check(launches == {"supcon_fwd": steps, "supcon_bwd": steps},
          f"expected one forward and one dz launch per step, got {launches}")

    sp = CONFIG["SPInfonceParams"]
    sched = PScheduler(max_epoch=CONFIG["Trainer"]["max_epoch"],
                       begin_value=sp["begin_values"], end_value=sp["end_values"], p=sp["p"])
    check(len(trainer.step_metrics) == steps, len(trainer.step_metrics))
    for rec in trainer.step_metrics:
        hm = rec["hooks"]["spinfonce/Conv5/partition"]
        check(math.isfinite(rec["reg_loss"]), rec)
        check(0.0 <= hm["sp_weight"] <= 1.0, rec)
        # gamma travels as a float32 metric
        check(abs(hm["age_param"] - sched.get_value(rec["epoch"] - 1)) < 1e-5, rec)
        print(f"epoch {rec['epoch']} reg_loss {rec['reg_loss']:.6f} "
              f"sp_weight {hm['sp_weight']:.4f} gamma {hm['age_param']:.4f}", flush=True)
    ckpt = save_dir / "last.ckpt"
    check(ckpt.exists(), f"{ckpt} missing")
    fresh = UNet(input_dim=1, num_classes=4, max_channel=CONFIG["Arch"]["max_channel"])
    fresh.load_state_dict(load_model_state_dict(str(ckpt)), strict=True)
    thr = trainer.last_epoch_stats["tra"]["throughput"]
    print(f"slice: {steps} steps in {wall:.2f} s incl. first-step warm-up; last epoch "
          f"{thr['steps_per_sec']:.3f} steps/s, {thr['slices_per_sec']:.1f} slices/s "
          f"({VIEWS} views per step); last.ckpt reloads strictly", flush=True)
    return launches, thr, trainer


# launches of the stage kernels in one train step: stage 1 (fed by an
# ordinary first convolution) skips `conv` and `dwdx`, stage 2 runs all seven
STAGE_LAUNCHES_PER_STEP = {"convstage_conv": 1, "convstage_bnconv": 2, "convstage_bnpool": 2,
                           "convstage_poolsums": 2, "convstage_dz1": 2,
                           "convstage_dwprev": 2, "convstage_dwdx": 1}


def slice_b_phase(sc, cs):
    phase("slice B: pretrain then fine-tune sweep and eval, small_c_layout pallas")
    import csv
    from spcl_torch.entry import build_trainer, val
    from spcl_torch.models import UNet
    from spcl_torch.training import load_model_state_dict

    config = copy.deepcopy(CONFIG)
    config["Arch"]["small_c_layout"] = "pallas"
    config["Trainer"]["save_dir"] = "runs/chip_smoke_b"
    save_dir = ROOT / config["Trainer"]["save_dir"]
    shutil.rmtree(save_dir, ignore_errors=True)
    steps = config["Trainer"]["max_epoch"] * config["Trainer"]["num_batches"]

    # ---- phase 1 of main_pretrain_encoder.py
    trainer = build_trainer(config, save_dir=str(save_dir / "pre"), pretrain=True,
                            device=DEVICE)
    check(trainer.model.small_c_layout == "pallas", trainer.model.small_c_layout)
    trainer.init()
    sc.reset_launch_counts()
    cs.reset_launch_counts()
    trainer.start_training()
    torch.cuda.synchronize()
    pre_launches = {**sc.LAUNCHES, **cs.LAUNCHES}
    want = {"supcon_fwd": steps, "supcon_bwd": steps,
            **{k: v * steps for k, v in STAGE_LAUNCHES_PER_STEP.items()}}
    print(f"pretrain launches in {steps} steps: {pre_launches}", flush=True)
    check(pre_launches == want, f"pretrain launches: expected {want}, got {pre_launches}")
    for rec in trainer.step_metrics:
        hm = rec["hooks"]["spinfonce/Conv5/partition"]
        check(math.isfinite(rec["reg_loss"]) and 0.0 <= hm["sp_weight"] <= 1.0, rec)
        print(f"pretrain reg_loss {rec['reg_loss']:.6f} sp_weight {hm['sp_weight']:.4f}",
              flush=True)
    ckpt = save_dir / "pre" / "last.ckpt"
    check(ckpt.exists(), f"{ckpt} missing")

    # ---- phase 2: the fine-tune sweep (one ratio), with eval after the epoch
    ft_config = copy.deepcopy(config)
    del ft_config["Trainer"]["name"]
    sc.reset_launch_counts()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    scores = val(base_config=ft_config, pretrained_checkpoint=str(ckpt),
                 save_dir=str(save_dir), labeled_ratios=[1], device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ft_launches = {**sc.LAUNCHES, **cs.LAUNCHES}
    # what the train steps alone launch: the eval epochs (val and test
    # loaders, eval mode) ran in the same call and added nothing
    want = {"supcon_fwd": 0, "supcon_bwd": 0,
            **{k: v * steps for k, v in STAGE_LAUNCHES_PER_STEP.items()}}
    print(f"fine-tune + eval launches in {steps} train steps: {ft_launches}", flush=True)
    check(ft_launches == want, f"fine-tune launches: expected {want}, got {ft_launches}")
    check(list(scores) == [1] and 0.0 <= scores[1] <= 1.0, f"DSC out of range: {scores}")
    run = save_dir / "tra_1"
    rows = list(csv.DictReader(open(run / "storage.csv")))
    check(len(rows) == 1, rows)
    for key in ("tra/sup_loss/mean", "val/loss/mean", "test/loss/mean",
                "val/dice/DSC_mean", "test/dice/DSC_mean"):
        check(math.isfinite(float(rows[0][key])), f"{key} = {rows[0][key]}")
    fresh = UNet(input_dim=1, num_classes=4, max_channel=config["Arch"]["max_channel"])
    fresh.load_state_dict(load_model_state_dict(str(run / "best.ckpt")), strict=True)
    print(f"fine-tune: {steps} steps + eval in {wall:.2f} s | sup_loss "
          f"{float(rows[0]['tra/sup_loss/mean']):.5f} | val loss "
          f"{float(rows[0]['val/loss/mean']):.5f} | val DSC {scores[1]:.5f} | test DSC "
          f"{float(rows[0]['test/dice/DSC_mean']):.5f} | best.ckpt reloads strictly into a "
          f"plain UNet", flush=True)
    launches = {k: pre_launches[k] + ft_launches[k] for k in cs.LAUNCHES}
    return launches, trainer


STAGE_KERNEL_NAMES = ("conv_fwd_kernel", "conv_bwd_kernel", "bnpool_kernel",
                      "poolsums_kernel", "dz1_kernel", "reduce_kernel")


def _pretrain_steps(trainer):
    from spcl_torch.training import batch_to_device
    it = iter(trainer._contrastive_loader)
    scalars = trainer._hook_scalars()

    def run(n):
        for _ in range(n):
            trainer._train_step(batch_to_device(next(it), DEVICE), trainer._generator,
                                scalars)
    return run


def _wall_ms(run, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _profiled(run, steps):
    """Kernel time by kernel (ms per step) of `steps` calls under
    torch.profiler: kernels only (device-side ranges of user annotations
    would count their kernels twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms = float(getattr(e, "self_device_time_total", 0.0)
                       or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / steps
            out[e.key] = (ms, e.count // steps)
    return out


def _print_profile(title, kernels, wall_ms, top=12):
    total = sum(ms for ms, _ in kernels.values())
    if total <= 0:
        print(f"profile {title}: the profiler recorded no device time (not measured)",
              flush=True)
        return None
    supcon = sum(ms for k, (ms, _) in kernels.items() if "supcon" in k)
    stage = sum(ms for k, (ms, _) in kernels.items()
                if any(n in k for n in STAGE_KERNEL_NAMES))
    print(f"profile {title}: {total:.3f} ms of kernel time per step = "
          f"{100 * total / wall_ms:.1f}% of the unprofiled wall time; supcon kernels "
          f"{supcon:.4f} ms/step = {100 * supcon / total:.2f}%; stage kernels "
          f"{stage:.3f} ms/step = {100 * stage / total:.1f}% of kernel time", flush=True)
    for key, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:8.3f} ms/step {100 * ms / total:5.1f}%  x{count:<4d} {key[:80]}",
              flush=True)
    return total


def profile_phase(trainer_a, trainer_b, steps=5, timed_steps=20):
    """More pretrain steps of both slices after the launch counts were read:
    `timed_steps` steps timed on the host clock (host batch gather and copy
    included, as in the trainer) in the turns nhwc, pallas, pallas, nhwc,
    then `steps` steps of each under torch.profiler."""
    phase(f"profile: pretrain step, nhwc beside pallas: {timed_steps} timed steps x 2 each, "
          f"then {steps} profiled steps each")
    run_a, run_b = _pretrain_steps(trainer_a), _pretrain_steps(trainer_b)
    run_a(2)
    run_b(2)  # warm-up
    a1 = _wall_ms(run_a, timed_steps)
    b1 = _wall_ms(run_b, timed_steps)
    b2 = _wall_ms(run_b, timed_steps)
    a2 = _wall_ms(run_a, timed_steps)
    wall_a, wall_b = min(a1, a2), min(b1, b2)
    for name, w, turns in (("nhwc", wall_a, (a1, a2)), ("pallas", wall_b, (b1, b2))):
        print(f"steady state {name}: {w:.3f} ms/step wall = {1e3 / w:.2f} steps/s, "
              f"{VIEWS * 1e3 / w:.1f} slices/s (host batch + copy included; turns "
              f"{turns[0]:.3f}, {turns[1]:.3f})", flush=True)
    print(f"pallas / nhwc step time: {wall_b / wall_a:.3f}", flush=True)
    total_a = _print_profile("nhwc", _profiled(run_a, steps), wall_a)
    total_b = _print_profile("pallas", _profiled(run_b, steps), wall_b)
    return {"nhwc_ms": wall_a, "pallas_ms": wall_b, "nhwc_kernel_ms": total_a,
            "pallas_kernel_ms": total_b}


def stage_region_phase():
    """Conv1 + pool + Conv2 + pool of the UNet alone at 2N = 60, forward and
    backward, through the fused stages beside the plain modules (cuDNN
    convolution, BatchNorm, max-pool, as the `nhwc` step runs them: TF32
    convolutions on), with the skip cotangents of e1 / e2 present (whole
    UNet) and absent (encoder pretrain). CUDA events and profiler."""
    phase("stage region: Conv1 + Conv2 with pools, forward + backward, B=60, 224^2")
    from spcl_torch.experimental.packed_stage import run_conv_stage
    from spcl_torch.models import UNet
    torch.manual_seed(0)
    net = UNet(max_channel=256).to(DEVICE).train()
    x = torch.rand(VIEWS, 1, 224, 224, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    c_e1 = torch.randn(VIEWS, 16, 224, 224, generator=gen, device=DEVICE)
    c_e2 = torch.randn(VIEWS, 32, 112, 112, generator=gen, device=DEVICE)
    c_p2 = torch.randn(VIEWS, 32, 56, 56, generator=gen, device=DEVICE)

    def region(fused, skips):
        def run():
            net.zero_grad(set_to_none=True)
            if fused:
                p1, e1 = run_conv_stage(net._Conv1, x, first_conv_plain=True)
                p2, e2 = run_conv_stage(net._Conv2, p1)
                e1, e2, p2 = (t.permute(0, 3, 1, 2) for t in (e1, e2, p2))
            else:
                e1 = net._Conv1(x)
                e2 = net._Conv2(net._pool(e1))
                p2 = net._pool(e2)
            loss = (p2 * c_p2).sum()
            if skips:
                loss = loss + (e1 * c_e1).sum() + (e2 * c_e2).sum()
            loss.backward()
        return run

    out = {}
    for skips in (True, False):
        for fused in (False, True, True, False):
            name = f"{'fused' if fused else 'cudnn'}_{'skips' if skips else 'noskips'}"
            ms = _time_ms(region(fused, skips), 5)
            out[name] = min(ms, out.get(name, ms))
        for fused in (False, True):
            name = f"{'fused' if fused else 'cudnn'}_{'skips' if skips else 'noskips'}"
            kernels = _profiled(lambda n, f=fused: [region(f, skips)() for _ in range(n)], 3)
            total = sum(ms for ms, _ in kernels.values())
            # the cotangent products and sums belong to the harness, not the stages
            print(f"{name}: {out[name]:.3f} ms by CUDA events (with the harness's loss); "
                  f"{total:.3f} ms of kernel time", flush=True)
            for key, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
                print(f"  {ms:8.3f} ms x{count:<3d} {key[:90]}", flush=True)
            out[name + "_kernel"] = total
    print("stage_region " + json.dumps(out), flush=True)
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def step_parity_phase():
    """One pretrain step of a UNet-256 to Conv5 at crop 32, 2N=12: on the
    card through the kernels, and on the CPU through the plain versions,
    from the same weights and the same augmentation/flip draws."""
    phase("step parity: card (kernels) vs CPU (plain)")
    import copy
    from spcl_torch.data.augment import ACDC_PRETRAIN, flip_params, sample_twice
    from spcl_torch.hooks import SelfPacedINFONCEHook
    from spcl_torch.models import UNet
    from spcl_torch.models.masking import set_trainable_stages, stages_from_range
    from spcl_torch.training import build_optimizer, build_pretrain_step
    import dataclasses

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(3)
    policy = dataclasses.replace(ACDC_PRETRAIN, crop=32)
    rng = np.random.default_rng(5)
    n = 6
    batch_np = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
                "partition": np.arange(n, dtype=np.int32) % 3,
                "patient": np.zeros(n, np.int32), "cycle": np.zeros(n, np.int32),
                "scan_idx": np.zeros(n, np.int32), "valid": np.ones(n, np.float32)}
    g = torch.Generator().manual_seed(11)
    draws = {"aug": sample_twice(g, n, policy, 48), "flip": flip_params(g, n)}
    base = UNet(max_channel=256)
    results = {}
    for dev in (DEVICE, "cpu"):
        model = copy.deepcopy(base).to(dev)
        set_trainable_stages(model, stages_from_range(None, "Conv5"))
        hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv5", weight=0.1,
                                    mode="hard", begin_value=3, end_value=14, max_epoch=2)
        torch.manual_seed(4)
        hook.build(model, dev)
        params = [p for p in model.parameters() if p.requires_grad] + hook.parameters()
        opt = build_optimizer(params, lr=1e-4, weight_decay=1e-5)
        step = build_pretrain_step(model, [hook], opt, policy=policy, total_freedom=True,
                                   until="Conv5")
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch_np.items()}
        m = step(batch, None, {"sp": {"gamma": 14.0}}, params=_to(draws, dev))
        results[dev] = (float(m["reg_loss"]), float(m["hooks"]["sp"]["sp_weight"]),
                        torch.cat([p.detach().cpu().flatten() for p in params]))
    (lk, rk, pk), (lp, rp, pp) = results[DEVICE], results["cpu"]
    perr = float((pk - pp).abs().max())
    print(f"reg_loss card {lk:.7f} cpu {lp:.7f} | sp_weight {rk:.4f} / {rp:.4f} | "
          f"max |param diff| after one RAdam step {perr:.2e}", flush=True)
    check(abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)), "step loss differs card vs CPU")
    check(abs(rk - rp) <= 1e-6, "sp_weight differs card vs CPU")
    check(perr <= 1e-5, "updated parameters differ card vs CPU")
    torch.backends.cudnn.allow_tf32 = True


def finetune_parity_phase(cs):
    """One fine-tune step of a UNet-256 under `small_c_layout="pallas"` at
    crop 32, batch 6: on the card through the stage kernels, and on the CPU
    through their plain versions, from the same weights and draws."""
    phase("fine-tune step parity under pallas: card (kernels) vs CPU (plain)")
    import dataclasses
    from spcl_torch.data.augment import ACDC_LABEL, sample_once
    from spcl_torch.models import UNet
    from spcl_torch.training import build_finetune_step, build_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(5)
    policy = dataclasses.replace(ACDC_LABEL, crop=32)
    rng = np.random.default_rng(9)
    n = 6
    batch_np = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
                "label": rng.integers(0, 4, (n, 48, 48), dtype=np.uint8),
                "valid": np.ones(n, np.float32)}
    draws = {"aug": sample_once(torch.Generator().manual_seed(13), n, policy, 48)}
    base = UNet(max_channel=256, small_c_layout="pallas")
    results = {}
    for dev in (DEVICE, "cpu"):
        model = copy.deepcopy(base).to(dev)
        params = list(model.parameters())
        opt = build_optimizer(params, lr=1e-4, weight_decay=1e-5)
        step = build_finetune_step(model, opt, num_classes=4, policy=policy)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch_np.items()}
        cs.reset_launch_counts()
        m = step(batch, None, params=_to(draws, dev))
        launched = sum(cs.LAUNCHES.values())
        check(launched == (sum(STAGE_LAUNCHES_PER_STEP.values()) if dev != "cpu" else 0),
              f"{dev}: {launched} stage kernel launches")
        stats = torch.cat([b.detach().float().cpu().flatten() for name, b in
                           model.named_buffers() if "running" in name
                           and ("_Conv1." in name or "_Conv2." in name)])
        results[dev] = (float(m["sup_loss"]), m["inter"].cpu(), stats,
                        torch.cat([p.detach().cpu().flatten() for p in params]))
    (lk, ik, sk, pk), (lp, ip, sp_, pp) = results[DEVICE], results["cpu"]
    perr = float((pk - pp).abs().max())
    serr = float((sk - sp_).abs().max())
    print(f"sup_loss card {lk:.7f} cpu {lp:.7f} | max |running stat diff| of Conv1/Conv2 "
          f"{serr:.2e} | max |param diff| after one RAdam step {perr:.2e} | max |inter diff| "
          f"{float((ik - ip).abs().max()):.0f} px", flush=True)
    check(abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)), "fine-tune loss differs card vs CPU")
    check(serr <= 1e-5, "running statistics differ card vs CPU")
    check(perr <= 1e-5, "updated parameters differ card vs CPU")
    torch.backends.cudnn.allow_tf32 = True


def main():
    smi = device_phase()
    sys.path.insert(0, str(ROOT))
    from spcl_torch.ops import convstage_cuda as cs
    from spcl_torch.ops import supcon_cuda as sc

    build_phase(sc, cs)
    if "--stage-kernels-only" in sys.argv[1:]:  # development aid: one phase
        stage_kernel_phase(cs)
        return
    max_err, timings = kernel_phase(sc)
    stage = stage_kernel_phase(cs)
    launches, thr, trainer_a = slice_phase(sc)
    stage_launches, trainer_b = slice_b_phase(sc, cs)
    steps = profile_phase(trainer_a, trainer_b)
    del trainer_a, trainer_b
    torch.cuda.empty_cache()
    stage_region_phase()
    step_parity_phase()
    finetune_parity_phase(cs)

    main_t = timings[MAIN_2N]
    why = ("no single PyTorch call computes the self-paced SupCon per-row "
           "statistics or their dz")
    replaces = {
        "supcon_fwd": "spcl_tpu/ops/supcon_pallas.py:121 _denom_kernel + :142 _loss_kernel",
        "supcon_bwd": "spcl_tpu/ops/supcon_pallas.py:167 _bwd_kernel",
    }
    kernels = [{"name": name, "route": "cuda", "source": "spcl_torch/ops/csrc/supcon.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": max_err[name], "ms": main_t[name]["ms"],
                "kernel_ms": main_t[name]["ms"],
                "plain_ms": main_t[name]["plain_ms"], "bound_ms": main_t[name]["bound_ms"],
                "bound_by": main_t[name]["bound_by"], "library_ms": None,
                "library_why": why, "at": f"2N={MAIN_2N}, D={D}"}
               for name in ("supcon_fwd", "supcon_bwd")]
    stage_why = ("no single PyTorch call computes a pass: each fuses BatchNorm, ReLU or the "
                 "pool with a convolution, its statistics or its weight gradient")
    for name in cs.PASSES:
        shapes = stage[name]["shapes"]
        # the entry's own numbers are those of the larger shape the pass runs at
        at = "stage1" if "stage1" in shapes else "stage2"
        kernels.append({
            "name": f"convstage_{name}", "route": "cuda",
            "source": "spcl_torch/ops/csrc/convstage.cu", "replaces": STAGE_REPLACES[name],
            "launches": stage_launches[f"convstage_{name}"],
            "max_abs_err": stage[name]["max_abs_err"], "ms": shapes[at]["ms"],
            "plain_ms": shapes[at]["plain_ms"], "bound_ms": shapes[at]["bound_ms"],
            "bound_by": shapes[at]["bound_by"],
            "library_ms": stage[name].get("library_ms"),
            "library_why": ("F.conv2d computes this pass's convolution, not its statistics"
                            if "library_ms" in stage[name] else stage_why),
            "at": shapes[at]["at"], "shapes": shapes})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(f"device: {smi} | slice A (nhwc) {1e3 / steps['nhwc_ms']:.3f} steps/s, "
          f"{VIEWS * 1e3 / steps['nhwc_ms']:.1f} slices/s ({steps['nhwc_ms']:.3f} ms/step) | "
          f"slice B pretrain step (pallas) {1e3 / steps['pallas_ms']:.3f} steps/s, "
          f"{VIEWS * 1e3 / steps['pallas_ms']:.1f} slices/s ({steps['pallas_ms']:.3f} ms/step), "
          f"steady state", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
