"""Torch-convention BatchNorm for the UNet, with cross-rank statistics.

`spcl_tpu/models/norm.py::TorchBatchNorm` pins torch's semantics on flax:
normalize with the biased batch variance, update the running variance with
the unbiased one, running = (1-m)*running + m*batch with m = 0.1, eps 1e-5.
In one process that is exactly `nn.BatchNorm2d(momentum=0.1, eps=1e-5)`.

In a multi-rank run the training statistics span the ranks, to the
arithmetic of `TorchBatchNorm` under an `axis_name` (norm.py:60-80): each
rank's mean and mean of squares are averaged over ranks (every rank holds the
same number of rows of the padded global batch), the variance is
E[x^2] - mean^2 clamped at 0, and the running variance takes Bessel's factor
with the GLOBAL count. The averages go through the differentiable sum of
`parallel/mesh.py`, so the gradient crosses the ranks too. `nn.SyncBatchNorm`
is not used: it has no CPU path, and one code path serves gloo on the CPU and
NCCL on the card. Parameters, buffers and state_dict keys are those of
`nn.BatchNorm2d`.

Under a low-precision compute dtype (bfloat16, `Arch.dtype`) every forward
follows flax as `TorchBatchNorm` does (norm.py:59-88): the statistics are
reduced in float32 from the input widened to float32 (train mode) or read
from the float32 running buffers (eval mode), w = scale * rsqrt(var + eps)
is formed in float32, and the apply (x - mean) * w + bias runs in the compute
dtype with mean, w and bias cast to it, so bf16 activations stay bf16. The
float32 single-rank path is `nn.BatchNorm2d`'s own.

`rank_local_statistics(model)` turns the cross-rank statistics off for a
block: the gradient-cache step (`training/gradcache.py`) normalises each
chunk with the rank's own statistics, as spcl_tpu's does (its UNet runs
without an `axis_name` inside the step's `shard_map`).

`CrossRankBatchNorm2d.packed(x)` is the BatchNorm of spcl_tpu's `packed`
layout (`experimental/packed_stage.py::_PackedBN`, :199-235), which the
UNet runs at Conv1 and Conv2 under `Arch.small_c_layout: packed`. It is not
this module's function: in train mode the one-pass statistics above (across
ranks too), but the running variance takes the **biased** batch variance;
in eval mode the running statistics; and the apply is x * inv + shift with
inv = weight * rsqrt(var + eps) and shift = bias - mean * inv, both rounded
to x's dtype, where `forward` subtracts the mean first.

On a CUDA tensor BatchNorm and the ReLU after it run as one function
(`bn_relu`, the kernels of `ops/bnrelu_cuda.py`) where the input is float32,
NCHW-contiguous, in train mode and without cross-rank statistics: the UNet's
`ConvBlock` and `UpConv` call it, and their ReLU modules stay in place, so
that state_dict keys and stage outputs are those of the plain path.
Channels-last inputs (cuDNN's NHWC kernels), bfloat16 (`_normalise`),
cross-rank statistics (`_batch_statistics`), eval mode and the `packed`
BatchNorm keep their paths.

`frozen_statistics(model)` keeps the running statistics where they are for
a block: a train-mode forward still normalises with the batch statistics but
updates no running mean, variance or count. It is spcl_tpu's `train=True,
update_stats=False` (training/steps.py:63-69), which the semi step uses for
its auxiliary forwards (the mixup forward, the `two_stage` + `disable_bn`
second pass); `freeze_statistics(model)` sets it for good (the EMA teacher).
The fused stages (`experimental/packed_stage.py`) read the same flag.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bnrelu_cuda
from ..parallel import mesh

BN_EPS = 1e-5  # TorchBatchNorm.epsilon


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode batch statistics span the ranks of
    the process group; without a group, in eval mode, and while
    `rank_local` is set, it is its parent. While `frozen_statistics` is set
    a train-mode forward updates no running statistic."""

    rank_local = False
    frozen_statistics = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cross_rank = self.training and mesh.active() and not self.rank_local
        if x.dtype == torch.float32 and not cross_rank:
            if not self.training:
                return super().forward(x)
            if self.frozen_statistics:
                return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            return super().forward(x)
        if not self.training:
            return self._normalise(x, self.running_mean, self.running_var)
        mean, var = self._batch_statistics(x, cross_rank, unbiased=True)
        return self._normalise(x, mean, var)

    def fused_relu(self, x: torch.Tensor) -> torch.Tensor:
        """relu(self(x)) in train mode as one function (`ops/bnrelu_cuda.py`):
        the batch statistics of this process, the running statistics moved
        unless frozen."""
        return bnrelu_cuda.bn_relu(
            x, self.weight, self.bias, (self.running_mean, self.running_var,
                                        self.num_batches_tracked),
            momentum=self.momentum, eps=self.eps, update=not self.frozen_statistics)

    def packed(self, x: torch.Tensor) -> torch.Tensor:
        """spcl_tpu's `_PackedBN` on NCHW `x`: batch statistics (running
        variance updated with the biased one) in train mode, the running
        statistics in eval mode; x * inv + shift in x's dtype."""
        if self.training:
            cross_rank = mesh.active() and not self.rank_local
            mean, var = self._batch_statistics(x, cross_rank, unbiased=False)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        shape = (1, -1, 1, 1)
        return x * inv.to(x.dtype).reshape(shape) + shift.to(x.dtype).reshape(shape)

    def _batch_statistics(self, x: torch.Tensor, cross_rank: bool, unbiased: bool):
        """(mean, var) of a train-mode batch in float32: the one-pass E[x^2] -
        mean^2 clamped at 0, averaged over the ranks when `cross_rank`; the
        running statistics move with them unless frozen, the variance with
        Bessel's factor when `unbiased`."""
        world = mesh.world_size() if cross_rank else 1
        xf = x.float()
        local = torch.stack([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        mean, mean2 = (mesh.all_reduce_sum(local) / world) if cross_rank else local
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if not self.frozen_statistics:
            self._update_running(x, world, mean, var, unbiased)
        return mean, var

    def _normalise(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        """(x - mean) * w + bias in x's dtype, w = weight * rsqrt(var + eps) in
        float32 (`TorchBatchNorm`'s subtract-first apply)."""
        w = self.weight * torch.rsqrt(var + self.eps)
        shape = (1, -1, 1, 1)
        return ((x - mean.to(x.dtype).reshape(shape)) * w.to(x.dtype).reshape(shape)
                + self.bias.to(x.dtype).reshape(shape))

    def _update_running(self, x, world, mean, var, unbiased=True) -> None:
        with torch.no_grad():
            n = world * x.numel() // x.shape[1]
            m = self.momentum
            if unbiased:
                var = var * (n / max(n - 1, 1))
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1


def fusable(norm: CrossRankBatchNorm2d, x: torch.Tensor) -> bool:
    """What the fused BatchNorm + ReLU needs, the device aside: a float32
    NCHW-contiguous input in train mode and statistics of this process
    alone."""
    return (x.dtype == torch.float32 and x.dim() == 4 and x.is_contiguous()
            and norm.training and norm.momentum is not None
            and not (mesh.active() and not norm.rank_local))


def fused_bn_relu_engages(norm: CrossRankBatchNorm2d, x: torch.Tensor) -> bool:
    """Whether `bn_relu` runs `norm` and its ReLU as one function on `x`: a
    `fusable` input on a card."""
    return x.is_cuda and fusable(norm, x)


def bn_relu(norm: CrossRankBatchNorm2d, relu: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """relu(norm(x)): one function where `fused_bn_relu_engages`, else the
    two modules."""
    if fused_bn_relu_engages(norm, x):
        return norm.fused_relu(x)
    return relu(norm(x))


def batch_norm(channels: int, momentum: float = 0.1) -> nn.BatchNorm2d:
    return CrossRankBatchNorm2d(channels, eps=BN_EPS, momentum=momentum)


def _norms(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, CrossRankBatchNorm2d)]


@contextlib.contextmanager
def rank_local_statistics(model: nn.Module):
    """Within the block every `CrossRankBatchNorm2d` of `model` computes its
    train-mode statistics over this rank's rows only."""
    norms = _norms(model)
    for m in norms:
        m.rank_local = True
    try:
        yield
    finally:
        for m in norms:
            m.rank_local = False


@contextlib.contextmanager
def frozen_statistics(model: nn.Module):
    """Within the block no train-mode forward of `model` moves a running
    statistic; the previous setting comes back after it."""
    norms = _norms(model)
    before = [m.frozen_statistics for m in norms]
    for m in norms:
        m.frozen_statistics = True
    try:
        yield
    finally:
        for m, b in zip(norms, before):
            m.frozen_statistics = b


def freeze_statistics(model: nn.Module) -> None:
    """No train-mode forward of `model` moves a running statistic again."""
    for m in _norms(model):
        m.frozen_statistics = True
