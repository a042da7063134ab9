"""DCGAN-style discriminator of the adversarial semi-supervised baseline.

The counterpart of `spcl_tpu/models/discriminator.py` (reference
semi_seg/arch/discr.py:14-40), in NCHW: four 4x4 stride-2 convolutions
(padding 1, with bias) at 64/128/256/512 channels, GroupNorm(min(32, ch))
after layers 1-3 with flax's eps of 1e-6 (torch's default is 1e-5),
leaky_relu(0.2) after each, a global mean over the pixels and a Linear to one
real/fake logit per image. The submodules carry the flax names (`conv{i}`,
`gn{i}`, `fc`), so `models/transplant.py::head_state_dict_from_flax` maps
the weights one to one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Discriminator(nn.Module):
    def __init__(self, in_channels: int, base_channels: int = 64):
        super().__init__()
        c = base_channels
        prev = in_channels
        for i, ch in enumerate((c, c * 2, c * 4, c * 8)):
            setattr(self, f"conv{i}", nn.Conv2d(prev, ch, 4, stride=2, padding=1))
            if i > 0:
                setattr(self, f"gn{i}", nn.GroupNorm(min(32, ch), ch, eps=1e-6))
            prev = ch
        self.fc = nn.Linear(prev, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] softmax prediction map (with the image's channels
        first under `dis_consider_image`) -> [B] real/fake logits."""
        x = x.float()
        for i in range(4):
            x = getattr(self, f"conv{i}")(x)
            if i > 0:
                x = getattr(self, f"gn{i}")(x)
            x = F.leaky_relu(x, negative_slope=0.2)
        return self.fc(x.mean(dim=(2, 3)))[:, 0]
