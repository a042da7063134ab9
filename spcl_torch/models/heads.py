"""Projection and cluster heads.

The counterparts of `spcl_tpu/models/heads.py` (reference
contrastyou/projectors/heads.py:78-169):

- `ProjectionHead` (:78-92): adaptive pool -> flatten -> Linear ->
  leaky_relu(0.01) -> Linear -> L2 normalisation (`l2_normalize`, eps
  1e-12). The flatten runs in (h, w, c) order, as the NHWC package does, so
  transplanted weights agree for any pooled grid.
- `DenseProjectionHead` (:96-120; spcl_tpu models/heads.py:102-125): a 1x1
  convolution MLP (conv0 -> leaky_relu(0.01) -> conv1) at the feature map's
  full resolution, THEN an adaptive pool to `spatial_size`, then an L2
  normalisation over channels; returns [B, D, h, w]. The MLP runs before
  the pool (pooling first would be cheaper, but the leaky_relu makes it
  another function). Its `hidden_dim` defaults to 128, as spcl_tpu's does.
- `ClusterHead` (:124-144): S independent subheads on the globally
  average-pooled features, each a Linear (or a 128-wide MLP) and a
  temperature softmax; returns [S, B, K].
- `DenseClusterHead` (:148-169): the same per pixel with 1x1 convolutions;
  returns [S, B, K, H, W] (the class axis second, NCHW).

The two projection heads pool by `pool_name`, "adaptive_avg" (the default) or
"adaptive_max", through `adaptive_avg_pool` / `adaptive_max_pool`. Their bins
are spcl_tpu's `_adaptive_pool_matrix` edges, floor(i H / s) .. ceil((i + 1)
H / s), which are also torch's. A bin's maximum is `torch.amax` over both
spatial axes at once: its backward shares the cotangent evenly among tied
maxima, as the backward of JAX's `jnp.max` does. `F.adaptive_max_pool2d` and
`max(dim)` send it all to one index, and ties are common after a ReLU
(windows of exact zeros).

Submodules carry the flax names (`fc0`/`fc1`, `conv0`/`conv1`, `sub{s}_fc0`,
`sub{s}_conv0`)
so that `models/transplant.py` maps the weights one to one.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

POOL_NAMES = ("adaptive_avg", "adaptive_max")


def _bin_index(n: int, s: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The positions [s, k] of `s` adaptive bins over `n` (spcl_tpu's and
    torch's edges floor(i n / s) .. ceil((i + 1) n / s), k the widest bin's
    size), narrower bins padded with their last position, and the mask of
    the positions that are not padding."""
    k = max(-((-(i + 1) * n) // s) - (i * n) // s for i in range(s))
    i = torch.arange(s, device=device)[:, None]
    start, end = (i * n) // s, -((-(i + 1) * n) // s)
    pos = start + torch.arange(k, device=device)
    return torch.minimum(pos, end - 1), pos < end


def adaptive_avg_pool(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """Adaptive average pooling of [B, C, H, W] to [B, C, oh, ow]."""
    oh, ow = output_size
    if tuple(x.shape[-2:]) == (oh, ow):
        return x
    if (oh, ow) == (1, 1):
        return x.mean(dim=(2, 3), keepdim=True)
    return F.adaptive_avg_pool2d(x, (oh, ow))


def bin_windows(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """Every adaptive bin of [B, C, H, W] gathered into [B, C, oh, kh, ow, kw]
    (kh, kw the widest bins' sizes), the padding of narrower bins read as
    -inf. One index_select an axis: its backward is an index_add, not the
    sort of an advanced index's."""
    b, c, h, w = x.shape
    oh, ow = output_size
    rows, row_ok = _bin_index(h, oh, x.device)
    cols, col_ok = _bin_index(w, ow, x.device)
    windows = x.index_select(2, rows.flatten()).index_select(3, cols.flatten())
    windows = windows.view(b, c, oh, rows.shape[1], ow, cols.shape[1])
    return windows.masked_fill(~(row_ok[:, :, None, None] & col_ok[None, None]), float("-inf"))


def adaptive_max_pool(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """Adaptive max pooling of [B, C, H, W] to [B, C, oh, ow]; at ties the
    gradient is shared evenly among a bin's maxima (JAX's rule)."""
    if tuple(output_size) == (1, 1):
        return torch.amax(x, dim=(2, 3), keepdim=True)
    return torch.amax(bin_windows(x, output_size), dim=(3, 5))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along `dim` (torch's F.normalize)."""
    return F.normalize(x, dim=dim, eps=eps)


def _pool_fn(pool_name: str):
    if pool_name not in POOL_NAMES:
        raise ValueError(f"pool_name {pool_name!r} is not one of {POOL_NAMES}")
    return adaptive_avg_pool if pool_name == "adaptive_avg" else adaptive_max_pool


class ProjectionHead(nn.Module):
    def __init__(self, input_dim: int, output_dim: int = 256, hidden_dim: int = 256,
                 head_type: str = "mlp", normalize: bool = True,
                 pool_name: str = "adaptive_avg", spatial_size: Tuple[int, int] = (1, 1)):
        super().__init__()
        if head_type not in ("mlp", "linear"):
            raise ValueError(head_type)
        self.head_type = head_type
        self.normalize = normalize
        self.pool_name = pool_name
        self._pool = _pool_fn(pool_name)
        self.spatial_size = tuple(spatial_size)
        in_features = input_dim * self.spatial_size[0] * self.spatial_size[1]
        if head_type == "mlp":
            self.fc0 = nn.Linear(in_features, hidden_dim)
            self.fc1 = nn.Linear(hidden_dim, output_dim)
        else:
            self.fc0 = nn.Linear(in_features, output_dim)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = self._pool(features.float(), self.spatial_size)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.fc0(x)
        if self.head_type == "mlp":
            x = self.fc1(F.leaky_relu(x, negative_slope=0.01))
        return l2_normalize(x, dim=-1) if self.normalize else x


class DenseProjectionHead(nn.Module):
    def __init__(self, input_dim: int, output_dim: int = 256, hidden_dim: int = 128,
                 head_type: str = "mlp", normalize: bool = True,
                 pool_name: str = "adaptive_avg", spatial_size: Tuple[int, int] = (10, 10)):
        super().__init__()
        if head_type not in ("mlp", "linear"):
            raise ValueError(head_type)
        self.head_type = head_type
        self.normalize = normalize
        self.pool_name = pool_name
        self._pool = _pool_fn(pool_name)
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
        x = self._pool(x, self.spatial_size)
        return l2_normalize(x, dim=1) if self.normalize else x


def _subhead_out(h: torch.Tensor, normalize: bool, temperature: float, dim: int):
    h = h.float()
    if normalize:
        h = l2_normalize(h, dim=dim)
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
