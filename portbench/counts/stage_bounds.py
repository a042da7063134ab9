"""Least time of each pass of the fused stage kernels (`spcl_torch/ops/
csrc/convstage.cu`), frozen from `chip_smoke.py::_stage_bounds` (float32)
and pointed at the dense TF32 peak: whatever implements a float32 pass, its
products may run in TF32, as cuDNN runs this configuration's convolutions.

A pass's bound is the larger of the bytes it must move (each input read once
and each output written once; activations 4 bytes an element, weights 4)
over the HBM rate, and its operations over the TF32 peak. `de=False` is the
pool passes without the skip cotangent.
"""
from __future__ import annotations

from typing import Dict

from ..peaks import H100

PASSES = ("conv", "bnconv", "bnpool", "poolsums", "dz1", "dwprev", "dwdx")


def stage_bounds(b: int, h: int, w: int, ci: int, c: int, de: bool = True,
                 act_bytes: int = 4) -> Dict[str, float]:
    """{pass: least seconds} of one stage: batch b, h x w pixels, ci input
    and c output channels."""
    f = act_bytes
    px = b * h * w
    skip = 1.0 if de else 0.0

    def conv_flops(i, o):
        return 2.0 * 9 * i * o * px

    bytes_ = {"conv": px * (ci + c) * f + 9 * ci * c * 4,
              "bnconv": px * 2 * c * f + 9 * c * c * 4,
              "bnpool": px * c * f * 2.25,              # z1 -> e, p
              "poolsums": px * c * f * (1.25 + skip),   # z1, de, dp
              "dz1": px * c * f * (2.25 + skip),        # z1, de, dp -> dz1
              "dwprev": px * c * f * 3 + 2 * 9 * c * c * 4,   # dz1, z0 -> dy0, dW1
              "dwdx": px * f * (2 * c + 2 * ci) + 2 * 9 * ci * c * 4}  # z0, dy0, x -> dx, dW0
    flops = {"conv": conv_flops(ci, c), "bnconv": conv_flops(c, c) + 3.0 * px * c,
             "bnpool": 4.0 * px * c, "poolsums": 9.0 * px * c, "dz1": 11.0 * px * c,
             "dwprev": 2 * conv_flops(c, c) + 4.0 * px * c,
             "dwdx": 2 * conv_flops(ci, c) + 4.0 * px * c}
    return {p: max(bytes_[p] / H100["hbm_bytes_per_s"], flops[p] / H100["tf32_flops"])
            for p in PASSES}
