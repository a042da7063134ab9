"""IIC mutual-information losses (the discrete-MI and MIDL baselines).

The counterpart of `spcl_tpu/losses/iic.py` (reference
contrastyou/losses/iic_loss.py):
- `iid_loss`              <-> IIDLoss (:17-51) + compute_joint (:131-151)
- `iid_segmentation_loss` <-> IIDSegmentationLoss (:54-100): the dense joint
  is the correlation of the two probability maps over a (2p+1)^2
  displacement window, one `F.conv2d` with the second map as the kernel, as
  the reference computes it.
- `iid_segmentation_small_patch_loss` <-> IIDSegmentationSmallPathLoss
  (:103-128): the dense loss averaged over half-overlapping patches.

Dense inputs are NCHW probability maps [B, K, H, W].
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F


def compute_joint(x_out: torch.Tensor, x_tf_out: torch.Tensor,
                  symmetric: bool = True) -> torch.Tensor:
    """[B, K] x [B, K] simplex inputs -> [K, K] joint distribution."""
    p = x_out.t() @ x_tf_out
    if symmetric:
        p = (p + p.t()) / 2.0
    return p / p.sum()


def iid_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, lamb: float = 1.0):
    """Negative mutual information of the paired cluster assignments:
    (loss, loss_no_lamb), the reference's first two outputs."""
    k = x_out.shape[1]
    p_i_j = compute_joint(x_out, x_tf_out)
    p_i = p_i_j.sum(dim=1, keepdim=True).expand(k, k)
    p_j = p_i_j.sum(dim=0, keepdim=True).expand(k, k)
    logs = torch.log(p_i_j + 1e-10)
    log_i = torch.log(p_i + 1e-10)
    log_j = torch.log(p_j + 1e-10)
    loss = -(p_i_j * (logs - lamb * log_j - lamb * log_i)).sum()
    loss_no_lamb = -(p_i_j * (logs - log_j - log_i)).sum()
    return loss, loss_no_lamb


def iid_segmentation_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, padding: int = 7,
                          lamb: float = 1.0, mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Dense IIC over probability maps [B, K, H, W]: the displacement joint
    p(k1, k2 | dy, dx), normalised per displacement."""
    if mask is not None:
        x_out = x_out * mask
        x_tf_out = x_tf_out * mask
    t = 2 * padding + 1
    # [K, B, H, W] input (N = k1, C = b) against [K, B, H, W] weight (O = k2, I = b)
    p = F.conv2d(x_out.transpose(0, 1), x_tf_out.transpose(0, 1), padding=padding)
    p = p - p.min().detach() + 1e-16                     # [k1, k2, T, T]
    p = p.permute(2, 3, 0, 1)                            # [T, T, k1, k2]
    p = p / p.sum(dim=(2, 3), keepdim=True)
    p = (p + p.transpose(2, 3)) / 2.0
    p_i = p.sum(dim=2, keepdim=True)
    p_j = p.sum(dim=3, keepdim=True)
    return -(p * (torch.log(p + 1e-16) - lamb * torch.log(p_i + 1e-16)
                  - lamb * torch.log(p_j + 1e-16))).sum() / (t * t)


def _patch_starts(size: int, patch: int, step: int) -> List[int]:
    starts = list(range(0, max(size - patch, 0), step)) or [0]
    last = max(size - patch, 0)
    if starts[-1] != last:
        starts.append(last)
    return starts


def iid_segmentation_small_patch_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor,
                                      padding: int = 7, patch_size: int = 32,
                                      lamb: float = 1.0,
                                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Patchified dense IIC (reference patch_generator, iic_loss.py:154-162):
    the mean of the dense loss over half-overlapping patches."""
    step = patch_size // 2
    h, w = x_out.shape[2], x_out.shape[3]
    losses = []
    for hs in _patch_starts(h, patch_size, step):
        for ws in _patch_starts(w, patch_size, step):
            sl = (slice(None), slice(None), slice(hs, hs + patch_size),
                  slice(ws, ws + patch_size))
            m = None if mask is None else mask[sl]
            losses.append(iid_segmentation_loss(x_out[sl], x_tf_out[sl], padding=padding,
                                                lamb=lamb, mask=m))
    return torch.stack(losses).mean()
