#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`spcl_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. device  — refuse to run without CUDA; print the card's name and power
               limit (nvidia-smi).
  2. build   — compile spcl_torch/ops/csrc/supcon.cu with nvcc for sm_90a.
  3. kernels — hold the supcon kernels against their plain PyTorch versions
               (float32, TF32 off) at 2N in {60, 126, 1024, 3840}, D=256,
               in every weighting mode, correct_grad on and off, and with
               padded (valid=0) rows; time kernel vs plain with CUDA events.
  4. slice   — the encoder-pretrain path of main_pretrain_encoder.py at the
               paper's configuration (UNet max_channel=256 to Conv5, crop
               224 of a 256 canvas, 2N=60, self-paced SupCon hard 3->14,
               RAdam) on synthetic data: 2 epochs x 5 steps through
               spcl_torch.entry.build_trainer; checks the kernel launch
               counts, finite losses, sp_weight in [0, 1], gamma following
               PScheduler, and a last.ckpt that reloads strictly.
  5. profile — 20 more steps timed (steady-state steps/s), 5 under
               torch.profiler (kernel time by kernel, device busy share).
  6. parity  — one small step on the card (kernels) against the same step
               on the CPU (plain versions) from the same weights and draws.
  7. report  — the `kernels` JSON line, the nvidia-smi line, a device line
               with the slice's throughput, and last
               {"ok": true, "device": {...}}.
"""
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
# Data.synthetic, max_epoch 2 and num_batches 5 (the port runs without pyyaml)
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
    "Trainer": {"save_dir": "runs/chip_smoke", "num_batches": 5, "max_epoch": 2,
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


def build_phase(sc):
    phase("build")
    path, seconds, log = sc.build(verbose=True)
    print(f"built {path.relative_to(ROOT)} in {seconds:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)
    return seconds


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


# ------------------------------------------------------------------ slice
def slice_phase(sc):
    phase("slice: encoder pretrain, UNet-256, 224^2, 2N=60")
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


def profile_phase(trainer, steps=5, timed_steps=20):
    """More steps of the slice after the launch counts were read: first
    `timed_steps` steps timed on the host clock (host batch gather and copy
    included, as in the trainer), then `steps` steps under torch.profiler for
    the device time by kernel."""
    phase(f"profile: {timed_steps} timed steps, then {steps} profiled steps")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spcl_torch.training import batch_to_device

    it = iter(trainer._contrastive_loader)
    scalars = trainer._hook_scalars()

    def run(n):
        for _ in range(n):
            trainer._train_step(batch_to_device(next(it), DEVICE), trainer._generator,
                                scalars)

    run(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(timed_steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    # kernels only: device-side ranges of user annotations (the optimizer's
    # step) would count their kernels twice
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]

    def dev_ms(e):  # per step
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / steps

    total = sum(dev_ms(e) for e in kernels)
    print(f"steady state: {wall_ms:.3f} ms/step wall = {1e3 / wall_ms:.2f} steps/s, "
          f"{VIEWS * 1e3 / wall_ms:.1f} slices/s (host batch + copy included)", flush=True)
    if total <= 0:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return wall_ms, None
    supcon = sum(dev_ms(e) for e in kernels if "supcon" in e.key)
    print(f"profile: {total:.3f} ms of kernel time per step = {100 * total / wall_ms:.1f}% "
          f"of the unprofiled wall time; supcon kernels {supcon:.4f} ms/step = "
          f"{100 * supcon / total:.2f}% of kernel time", flush=True)
    for e in sorted(kernels, key=dev_ms, reverse=True)[:12]:
        print(f"  {dev_ms(e):8.3f} ms/step {100 * dev_ms(e) / total:5.1f}%  "
              f"x{e.count // steps:<4d} {e.key[:80]}", flush=True)
    return wall_ms, total


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


def main():
    smi = device_phase()
    sys.path.insert(0, str(ROOT))
    from spcl_torch.ops import supcon_cuda as sc

    build_phase(sc)
    max_err, timings = kernel_phase(sc)
    launches, thr, trainer = slice_phase(sc)
    wall_ms, _ = profile_phase(trainer)
    step_parity_phase()

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(f"device: {smi} | slice {1e3 / wall_ms:.3f} steps/s, "
          f"{VIEWS * 1e3 / wall_ms:.1f} slices/s (steady state, {wall_ms:.3f} ms/step)",
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
