"""The fused small-channel encoder stages of the UNet (`Arch.small_c_layout:
pallas`), run by the CUDA kernels of `ops/convstage_cuda.py`.

The counterpart of `spcl_tpu/experimental/packed_stage.py::PallasConvStage`
(:271-304) and `packable` (:46-56). The config value keeps the JAX package's
name so that one config file serves both packages; on the GPU the stage is a
direct channels-last convolution, not a lane-packed one.

`run_conv_stage` adds no parameters: it reads a `ConvBlock`'s own modules
(`conv.0`, `.1`, `.3`, `.4`), so state_dict keys and checkpoints are those of
the plain path. The kernels are built for 16 and 32 channels (the UNet at
max_channel 256); on the card another packable width raises, on the CPU the
plain versions take any. After the stage it updates the BatchNorm running statistics
as the JAX `pallas` path does (`_BNVars`, :253-256): with the **biased**
batch variance, where `nn.BatchNorm2d` on the plain path uses the unbiased
one; not while the BatchNorm's statistics are frozen
(`models/norm.py::frozen_statistics`, spcl_tpu's `update_stats=False`).

Under `Arch.dtype: bfloat16` the stage runs in bf16 as spcl_tpu's
`PallasConvStage(dtype=...)` does (:271-304): stage 1's first convolution
(one input channel) is the UNet's own `Conv2d` on the bf16 input, weights
rounded to bf16, in cuDNN, and its bf16 output is the stage's z0; the
kernels' bf16 instantiation stores the activations in bf16 and keeps the
BatchNorm statistics in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.convstage_cuda import fused_conv_stage


def packable(w: int, c1: int, c2: int) -> bool:
    """True when input width `w` and stage channels (c1, c2) satisfy the
    grouping constraints of the JAX package's packed stage-1/2 pipeline. The
    port keeps the same rule so that both packages take the fused path for
    the same shapes (the UNet's 224/256 crops at max_channel 256 qualify)."""
    if w % 4 != 0:
        return False
    for width, c in ((w, c1), (w // 2, c1), (w // 2, c2), (w // 4, c2)):
        if (width * c) % 128 != 0:
            return False
    return c1 <= 128 and c2 <= 128 and 128 % c1 == 0 and 128 % c2 == 0


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """[Co, Ci, 3, 3] parameter -> [3, 3, Ci, Co] (autograd carries the
    gradient back through the permute)."""
    return conv.weight.permute(2, 3, 1, 0).contiguous()


@torch.no_grad()
def _update_running(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    if getattr(bn, "frozen_statistics", False):
        return
    m = bn.momentum
    bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
    bn.running_var.mul_(1.0 - m).add_(var, alpha=m)  # biased, as in spcl_tpu
    bn.num_batches_tracked += 1


def run_conv_stage(block: nn.Module, x: torch.Tensor, *,
                   first_conv_plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode ConvBlock + 2x2 max-pool through the fused stage.

    `block.conv` is the ConvBlock's Sequential (conv, BN, ReLU, conv, BN,
    ReLU). `first_conv_plain`: `x` is NCHW and the first convolution runs as
    an ordinary `nn.Conv2d` whose channels-last output feeds the stage
    (stage 1, one input channel); otherwise `x` is channels-last
    [B, H, W, Ci]. Returns channels-last (p, e): the pooled output and the
    pre-pool activation."""
    conv0, bn0, conv1, bn1 = block.conv[0], block.conv[1], block.conv[3], block.conv[4]
    if first_conv_plain:
        z0 = conv0(x).permute(0, 2, 3, 1).contiguous()
        p, e, mean0, var0, mean1, var1 = fused_conv_stage(
            z0, None, bn0.weight, bn0.bias, _hwio(conv1), bn1.weight, bn1.bias,
            external_first=True)
    else:
        p, e, mean0, var0, mean1, var1 = fused_conv_stage(
            x, _hwio(conv0), bn0.weight, bn0.bias, _hwio(conv1), bn1.weight, bn1.bias)
    _update_running(bn0, mean0, var0)
    _update_running(bn1, mean1, var1)
    return p, e
