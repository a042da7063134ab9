"""The convolution of spcl_tpu's `packed` layout on NCHW tensors.

spcl_tpu's lane-packed stages (`experimental/packed_stage.py::packed_conv`,
:144-178) compute a 3x3 convolution as nine matmuls of the packed rows, one
for each (vertical tap u, lane-group shift s), summed in the compute dtype.
Lane group j holds G = 128 / Ci adjacent columns, so the matmul of shift s
carries, for an output column at position p = w mod G of its group, the
horizontal taps v whose input column p + v - 1 falls in group j + s - 1.

In float32 that is the convolution up to the order of float32 additions,
and `packed_conv` is the UNet's own `F.conv2d`. In bfloat16 every one of
the nine partial sums is rounded to bf16 and they are added in bf16, u-major
then s: `packed_conv` keeps those rounding points, with each partial summed
in float32 from the bf16 operands (exact products) as XLA's dot does. The
layout itself has no counterpart on the GPU; only its arithmetic is kept.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _group_shift(pos: torch.Tensor, v: int, g: int) -> torch.Tensor:
    """The lane-group shift + 1 (0, 1, 2) that horizontal tap v reads from,
    for output columns at position `pos` of their group of g columns."""
    col = pos + v - 1
    return torch.where(col < 0, 0, torch.where(col >= g, 2, 1))


def packed_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """3x3 same-padding convolution of NCHW `x` by the float32 [Co, Ci, 3, 3]
    `weight` (no bias) as spcl_tpu's `packed_conv` computes it in x's dtype."""
    if x.dtype == torch.float32:
        return F.conv2d(x, weight, padding=1)
    _, ci, h, w = x.shape
    g = 128 // ci
    wq = weight.to(x.dtype).float()
    xp = F.pad(x, (1, 1, 1, 1)).float()
    pos = torch.arange(w, device=x.device) % g
    out = None
    for u in range(3):
        taps = [F.conv2d(xp[:, :, u:u + h, v:v + w], wq[:, :, u:u + 1, v:v + 1])
                for v in range(3)]
        for s in range(3):
            part = sum(tap * (_group_shift(pos, v, g) == s) for v, tap in enumerate(taps))
            part = part.to(x.dtype)
            out = part if out is None else out + part
    return out
