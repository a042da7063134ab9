"""Pooled projection head for encoder features.

The counterpart of `spcl_tpu/models/heads.py::ProjectionHead` (reference
contrastyou/projectors/heads.py:78-92): adaptive average pool -> flatten ->
Linear -> leaky_relu(0.01) -> Linear -> L2 normalisation (torch
F.normalize, eps 1e-12). Submodules are named `fc0`/`fc1` like the flax
Dense layers; the flatten runs in (h, w, c) order, as the NHWC package does,
so transplanted weights agree for any pooled grid.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ProjectionHead(nn.Module):
    def __init__(self, input_dim: int, output_dim: int = 256, hidden_dim: int = 256,
                 head_type: str = "mlp", normalize: bool = True,
                 spatial_size: Tuple[int, int] = (1, 1)):
        super().__init__()
        if head_type not in ("mlp", "linear"):
            raise ValueError(head_type)
        self.head_type = head_type
        self.normalize = normalize
        self.spatial_size = tuple(spatial_size)
        in_features = input_dim * self.spatial_size[0] * self.spatial_size[1]
        if head_type == "mlp":
            self.fc0 = nn.Linear(in_features, hidden_dim)
            self.fc1 = nn.Linear(hidden_dim, output_dim)
        else:
            self.fc0 = nn.Linear(in_features, output_dim)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = F.adaptive_avg_pool2d(features.float(), self.spatial_size)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.fc0(x)
        if self.head_type == "mlp":
            x = self.fc1(F.leaky_relu(x, negative_slope=0.01))
        return F.normalize(x, dim=-1, eps=1e-12) if self.normalize else x
