#!/usr/bin/env python
"""Digests of every stage kernel's outputs on seeded inputs, on the GPU: this
tree's kernels beside another tree's, to show which passes give the same bits.

    python3 scripts/stage_bits.py --parent DIR

For each shape (the main path's S1 = 60 x 224 x 224 x 16 after an ordinary
first convolution, S2 = 60 x 112 x 112, 16 -> 32, and a small one whose H and
W are no tile multiples) and each dtype (float32, bfloat16), the stage's
inputs are drawn from a seeded generator, the plain versions make the
residuals and cotangents, and then each of the seven kernels runs alone on
them; printed: a sha256 of each pass's output bytes. This tree and the one
in DIR (a directory holding a `spcl_torch/`, e.g. `git archive <commit>
spcl_torch | tar -x -C DIR`) each run in their own process on the same
inputs. The passes in SAME must agree bit for bit; the script exits 1 if one
does not. They are those whose results the last kernel change left alone:
every pass in both dtypes but the bf16 poolsums, whose kernel of its own
(16-byte lanes of 8 channels) adds its terms in another order. The card's
name and power limit are printed beside the result.
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("S1", 60, 224, 224, 16, 16, True), ("S2", 60, 112, 112, 16, 32, False),
          ("small", 3, 20, 36, 16, 32, False))
PASSES = ("conv", "bnconv", "bnpool", "poolsums", "dz1", "dwprev", "dwdx")
SAME = ("conv", "bnconv", "bnpool", "poolsums", "dz1", "dwprev", "dwdx",
        "conv_bf16", "bnconv_bf16", "bnpool_bf16", "dz1_bf16", "dwprev_bf16", "dwdx_bf16")


def _digest(out):
    import torch
    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree):
    """Digest `tree`'s kernels' outputs; print one JSON line."""
    sys.path[:0] = [str(Path(tree).resolve())]
    import torch
    from spcl_torch.ops import convstage_cuda as cs
    assert Path(cs.__file__).resolve().is_relative_to(Path(tree).resolve()), cs.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cs.build()
    out = {}
    for name, b, h, w, ci, c, ext in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(b + h + c)

            def rn(*shape, scale=1.0):
                return torch.randn(*shape, generator=gen, device="cuda") * scale

            x = rn(b, h, w, c if ext else ci).to(dtype)
            w0 = None if ext else rn(3, 3, ci, c, scale=(9 * ci) ** -0.5)
            args = (x, w0, 1 + rn(c, scale=0.1), rn(c, scale=0.1),
                    rn(3, 3, c, c, scale=(9 * c) ** -0.5), 1 + rn(c, scale=0.1),
                    rn(c, scale=0.1))
            dp, de = rn(b, h // 2, w // 2, c).to(dtype), rn(b, h, w, c).to(dtype)
            _, res = cs.stage_forward(*args, ext, plain=True)  # the same in every tree
            x, z0, z1, w0, w1, g0, g1, mean0, var0, coef0, mean1, var1, coef1 = res
            n = b * h * w
            dcoef1 = cs.bn_bwd_coef(cs.poolsums_plain(z1, coef1, dp, de), n, mean1, var1,
                                    g1)[0]
            dz1 = cs.dz1_plain(z1, coef1, dcoef1, dp, de)
            dy0, _, sums = cs.dwprev_plain(dz1, z0, coef0, w1)
            dcoef0 = cs.bn_bwd_coef(sums, n, mean0, var0, g0)[0]
            inputs = {"bnconv": (z0, coef0, w1), "bnpool": (z1, coef1),
                      "poolsums": (z1, coef1, dp, de), "dz1": (z1, coef1, dcoef1, dp, de),
                      "dwprev": (dz1, z0, coef0, w1)}
            if not ext:
                inputs.update({"conv": (x, w0), "dwdx": (z0, dy0, dcoef0, x, w0)})
            suffix = "_bf16" if dtype == torch.bfloat16 else ""
            for p in PASSES:
                if p in inputs:
                    out[f"{name} {p}{suffix}"] = _digest(cs._KERNEL_PASSES[p](*inputs[p]))
            del res, args, dz1, dy0, inputs
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--parent", help="a directory holding another tree's spcl_torch/")
    args = ap.parse_args()
    if args.tree:
        worker(args.tree)
        return
    if not args.parent:
        ap.error("--parent DIR is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the stage kernels have no CPU mode")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    results = {}
    for name, tree in ((Path(args.parent).name, args.parent), ("this", ROOT)):
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        results[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"{smi} | sha256 of each pass's outputs; trees: {', '.join(results)}")
    bad = []
    for key in results["this"]:
        digests = {r.get(key) for r in results.values()}
        same = len(digests) == 1
        must = key.split(" ", 1)[1] in SAME
        print(f"  {key:22s} {'same bits' if same else 'differ'}"
              f"{' (must be the same)' if must else ''}: "
              + " | ".join(f"{n} {r.get(key)}" for n, r in results.items()), flush=True)
        if must and not same:
            bad.append(key)
    if bad:
        raise SystemExit(f"passes that must give the same bits differ: {bad}")


if __name__ == "__main__":
    main()
