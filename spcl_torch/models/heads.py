"""Projection and cluster heads.

The counterparts of `spcl_tpu/models/heads.py` (reference
contrastyou/projectors/heads.py:78-169):

- `ProjectionHead` (:78-92): adaptive average pool -> flatten -> Linear ->
  leaky_relu(0.01) -> Linear -> L2 normalisation (torch F.normalize, eps
  1e-12). The flatten runs in (h, w, c) order, as the NHWC package does, so
  transplanted weights agree for any pooled grid.
- `DenseProjectionHead` (:96-120; spcl_tpu models/heads.py:102-125): a 1x1
  convolution MLP (conv0 -> leaky_relu(0.01) -> conv1) at the feature map's
  full resolution, THEN an adaptive average pool to `spatial_size`, then an
  L2 normalisation over channels; returns [B, D, h, w]. The MLP runs before
  the pool (pooling first would be cheaper, but the leaky_relu makes it
  another function). `F.adaptive_avg_pool2d` has the bin edges of
  spcl_tpu's `_adaptive_pool_matrix` (floor(i H / s) .. ceil((i + 1) H / s)).
- `ClusterHead` (:124-144): S independent subheads on the globally
  average-pooled features, each a Linear (or a 128-wide MLP) and a
  temperature softmax; returns [S, B, K].
- `DenseClusterHead` (:148-169): the same per pixel with 1x1 convolutions;
  returns [S, B, K, H, W] (the class axis second, NCHW).

Submodules carry the flax names (`fc0`/`fc1`, `conv0`/`conv1`, `sub{s}_fc0`,
`sub{s}_conv0`)
so that `models/transplant.py` maps the weights one to one.
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


class DenseProjectionHead(nn.Module):
    def __init__(self, input_dim: int, output_dim: int = 256, hidden_dim: int = 256,
                 head_type: str = "mlp", normalize: bool = True,
                 spatial_size: Tuple[int, int] = (10, 10)):
        super().__init__()
        if head_type not in ("mlp", "linear"):
            raise ValueError(head_type)
        self.head_type = head_type
        self.normalize = normalize
        self.spatial_size = tuple(spatial_size)
        if head_type == "mlp":
            self.conv0 = nn.Conv2d(input_dim, hidden_dim, 1)
            self.conv1 = nn.Conv2d(hidden_dim, output_dim, 1)
        else:
            self.conv0 = nn.Conv2d(input_dim, output_dim, 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = self.conv0(features.float())
        if self.head_type == "mlp":
            x = self.conv1(F.leaky_relu(x, negative_slope=0.01))
        x = F.adaptive_avg_pool2d(x, self.spatial_size)
        return F.normalize(x, dim=1, eps=1e-12) if self.normalize else x


def _subhead_out(h: torch.Tensor, normalize: bool, temperature: float, dim: int):
    h = h.float()
    if normalize:
        h = F.normalize(h, dim=dim, eps=1e-12)
    return torch.softmax(h / temperature, dim=dim)


class ClusterHead(nn.Module):
    """S-subhead pooled cluster head with temperature softmax -> [S, B, K]."""

    def __init__(self, input_dim: int, num_clusters: int = 5, num_subheads: int = 10,
                 head_type: str = "linear", temperature: float = 1.0,
                 normalize: bool = False):
        super().__init__()
        if head_type not in ("mlp", "linear"):
            raise ValueError(head_type)
        self.head_type = head_type
        self.num_subheads = int(num_subheads)
        self.temperature = float(temperature)
        self.normalize = normalize
        for s in range(self.num_subheads):
            if head_type == "linear":
                setattr(self, f"sub{s}_fc0", nn.Linear(input_dim, num_clusters))
            else:
                setattr(self, f"sub{s}_fc0", nn.Linear(input_dim, 128))
                setattr(self, f"sub{s}_fc1", nn.Linear(128, num_clusters))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features.float().mean(dim=(2, 3))  # global average pool
        outs = []
        for s in range(self.num_subheads):
            h = getattr(self, f"sub{s}_fc0")(x)
            if self.head_type == "mlp":
                h = getattr(self, f"sub{s}_fc1")(F.leaky_relu(h, negative_slope=0.01))
            outs.append(_subhead_out(h, self.normalize, self.temperature, -1))
        return torch.stack(outs, dim=0)


class DenseClusterHead(nn.Module):
    """S-subhead dense cluster head (1x1 convolutions, per-pixel temperature
    softmax) -> [S, B, K, H, W]."""

    def __init__(self, input_dim: int, num_clusters: int = 10, hidden_dim: int = 64,
                 num_subheads: int = 10, head_type: str = "linear",
                 temperature: float = 1.0, normalize: bool = False):
        super().__init__()
        if head_type not in ("mlp", "linear"):
            raise ValueError(head_type)
        self.head_type = head_type
        self.num_subheads = int(num_subheads)
        self.temperature = float(temperature)
        self.normalize = normalize
        for s in range(self.num_subheads):
            if head_type == "linear":
                setattr(self, f"sub{s}_conv0", nn.Conv2d(input_dim, num_clusters, 1))
            else:
                setattr(self, f"sub{s}_conv0", nn.Conv2d(input_dim, hidden_dim, 1))
                setattr(self, f"sub{s}_conv1", nn.Conv2d(hidden_dim, num_clusters, 1))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        outs = []
        features = features.float()
        for s in range(self.num_subheads):
            h = getattr(self, f"sub{s}_conv0")(features)
            if self.head_type == "mlp":
                h = getattr(self, f"sub{s}_conv1")(F.leaky_relu(h, negative_slope=0.01))
            outs.append(_subhead_out(h, self.normalize, self.temperature, 1))
        return torch.stack(outs, dim=0)
