#!/usr/bin/env python
"""The backward convolution passes of the fused stages against float64, on
the GPU: this tree's kernels beside another tree's.

    python3 scripts/measure_stage_accuracy.py [--dtype float32|bfloat16] [--parent DIR ...]
        [--turns N] [--out FILE]

For each case (stage 1: B x 224 x 224, 16 channels; stage 2: B x 112 x 112,
16 -> 32; B = 32, 60, 96, the EMA teacher's, the pretrain step's and the
semi step's batches) the inputs of `dwprev` and `dwdx` are drawn from a
seeded generator: z0, x and the weights random, the gradient (dz1, dy0)
random and projected as the BatchNorm backward projects it (zero mean and
no component along the normalised activation, per channel), which makes the
sums over pixels cancel as they do in training. Each pass runs as the
kernel (`*_kernel`), as the plain version (`*_plain`, cuDNN with TF32 off)
and in float64 (`convstage_cuda.float64_pass`, this tree's for every tree:
the plain versions compute in float32); printed: max|x - float64| /
max|float64| for each output — the weight gradient, the input gradient and,
for dwprev, the BatchNorm backward sums (sum dy0, sum dy0*z0) — and each
kernel's time (CUDA events around 20 calls on the same inputs, after 3
warm-up calls).

--dtype bfloat16 stores the activations and gradients (z0, x, dz1, dy0) in
bf16 and runs the bf16 kernels; the float64 reference then multiplies the
operands the bf16 kernels multiply: a0 = relu(y0) rounded to bf16 from the
float32 y0 = z0*inv + shift (whose sign is the ReLU mask), dz0 = c0*dy0 + c1
+ c2*z0 rounded to bf16, the weights rounded to bf16. The input gradients
(dy0, dx) are stored in bf16, so their errors include that rounding (up to
2^-8 of an element); the weight gradients and the sums are float32.

With --parent DIR (a directory holding another tree's `spcl_torch/`, e.g.
`git archive <commit> spcl_torch | tar -x -C DIR`; may be given more than
once) each tree runs in its own process, the others first; the inputs are
the same in all. --turns N runs the trees N times, every other turn in the
reverse order (parent, this, this, parent for two trees and two turns); the
times printed are each tree's least over the turns, and the errors, which do
not vary between runs, those of its first turn. The card's name and power
limit are printed beside the numbers.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = (("S1 B=32", 32, 224, 224, 16, 16), ("S1 B=60", 60, 224, 224, 16, 16),
         ("S1 B=96", 96, 224, 224, 16, 16), ("S2 B=96", 96, 112, 112, 16, 32))


def _projected(gen, shape, z):
    """A random gradient with the BatchNorm backward's projection: per
    channel, no mean and no component along the normalised z."""
    import torch
    g = torch.randn(*shape, generator=gen, device="cuda")
    zn = (z - z.mean(dim=(0, 1, 2))) / z.std(dim=(0, 1, 2))
    return g - g.mean(dim=(0, 1, 2)) - zn * (g * zn).mean(dim=(0, 1, 2))


def _rel(x, ref):
    return float((x.double() - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def _kernel_ms(fn, args, reps=20):
    import torch
    for _ in range(3):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def worker(tree, dtype_name):
    """Measure `tree`'s kernels in `dtype_name`; print one JSON line."""
    sys.path[:0] = [str(ROOT)]
    import torch
    from spcl_torch.ops.convstage_cuda import float64_pass  # the reference: this tree's
    for mod in [m for m in sys.modules if m.split(".")[0] == "spcl_torch"]:
        del sys.modules[mod]
    sys.path[:0] = [str(Path(tree).resolve())]
    from spcl_torch.ops import convstage_cuda as cs
    assert Path(cs.__file__).resolve().is_relative_to(Path(tree).resolve()), cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build()
    dtype = getattr(torch, dtype_name)
    out = {}
    for name, b, h, w, ci, c in CASES:
        gen = torch.Generator(device="cuda").manual_seed(b + c)
        z0 = torch.randn(b, h, w, c, generator=gen, device="cuda").to(dtype)
        z1 = torch.randn(b, h, w, c, generator=gen, device="cuda")
        coef = torch.stack([1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
                            0.1 * torch.randn(c, generator=gen, device="cuda")]).contiguous()
        w1 = torch.randn(3, 3, c, c, generator=gen, device="cuda") * (9 * c) ** -0.5
        dz1 = _projected(gen, (b, h, w, c), z1).to(dtype).contiguous()
        case = {}
        args = (dz1, z0, coef, w1)
        k, p = cs.dwprev_kernel(*args), cs.dwprev_plain(*args)
        r = float64_pass("dwprev", *args)
        for i, what in enumerate(("dy0", "dW1")):
            case[f"dwprev {what}"] = (_rel(k[i], r[i]), _rel(p[i], r[i]))
        for j, what in enumerate(("sum dy0", "sum dy0*z0")):
            case[f"dwprev {what}"] = (_rel(k[2][j], r[2][j]), _rel(p[2][j], r[2][j]))
        del k, p, r
        case["dwprev ms"] = _kernel_ms(cs.dwprev_kernel, args)
        if ci != c:  # stage 2 starts with a convolution of its own: dwdx runs
            x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(dtype)
            w0 = torch.randn(3, 3, ci, c, generator=gen, device="cuda") * (9 * ci) ** -0.5
            dy0 = _projected(gen, (b, h, w, c), z0.float()).to(dtype).contiguous()
            dcoef = torch.stack([1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
                                 0.01 * torch.randn(c, generator=gen, device="cuda"),
                                 0.01 * torch.randn(c, generator=gen, device="cuda")]).contiguous()
            args = (z0, dy0, dcoef, x, w0)
            k, p = cs.dwdx_kernel(*args), cs.dwdx_plain(*args)
            r = float64_pass("dwdx", *args)
            for i, what in enumerate(("dx", "dW0")):
                case[f"dwdx {what}"] = (_rel(k[i], r[i]), _rel(p[i], r[i]))
            del k, p, r
            case["dwdx ms"] = _kernel_ms(cs.dwdx_kernel, args)
        out[name] = case
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def _run_tree(tree, dtype_name):
    proc = subprocess.run([sys.executable, __file__, "--tree", str(tree), "--dtype", dtype_name],
                          capture_output=True, text=True)
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
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the activations' dtype, the kernels' instantiation")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args()
    if args.tree:
        worker(args.tree, args.dtype)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the stage kernels have no CPU mode")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    trees = [(Path(t).name, t) for t in args.parent] + [("this", ROOT)]
    results = {}
    for turn in range(args.turns):
        for name, tree in (trees if turn % 2 == 0 else trees[::-1]):
            r = _run_tree(tree, args.dtype)
            if name not in results:
                results[name] = r
                continue
            for case, fields in r.items():
                for what, value in fields.items():
                    if what.endswith(" ms"):
                        results[name][case][what] = min(results[name][case][what], value)
    print(f"{smi} | {args.dtype} | max|x - float64| / max|float64|: kernel (plain); kernel "
          f"ms, least of {args.turns} turn(s)")
    for case in CASES:
        for what in results["this"][case[0]]:
            print(f"  {case[0]:8s} {what:18s} " + " | ".join(
                f"{name} {r[case[0]][what]:.4f}" if what.endswith(" ms") else
                f"{name} {r[case[0]][what][0]:.2e} ({r[case[0]][what][1]:.2e})"
                for name, r in results.items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi, "dtype": args.dtype,
                                              "results": results}, indent=1))


if __name__ == "__main__":
    main()
