"""Torch-convention BatchNorm for the UNet.

`spcl_tpu/models/norm.py::TorchBatchNorm` pins torch's semantics on flax:
normalize with the biased batch variance, update the running variance with
the unbiased one, running = (1-m)*running + m*batch with m = 0.1, eps 1e-5.
That is exactly `nn.BatchNorm2d(momentum=0.1, eps=1e-5)`, so here it is one.
"""
from __future__ import annotations

from torch import nn

BN_EPS = 1e-5  # TorchBatchNorm.epsilon


def batch_norm(channels: int, momentum: float = 0.1) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=momentum)
