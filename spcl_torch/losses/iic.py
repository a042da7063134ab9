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

The joints are sums over the batch. In a multi-rank run (`parallel/mesh.py`)
the inputs are this rank's rows: the unnormalised joints are summed over
ranks (`mesh.all_reduce_sum`, one collective for all the joints of a call)
before they are normalised, every rank computes the loss of the global
batch in full, and the loss enters the backward through `mesh.grad_share`.
In one process this is the single-device loss.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel import mesh

Pair = Tuple[torch.Tensor, torch.Tensor]


def _normalise_joint(p: torch.Tensor, symmetric: bool = True) -> torch.Tensor:
    if symmetric:
        p = (p + p.t()) / 2.0
    return p / p.sum()


def compute_joint(x_out: torch.Tensor, x_tf_out: torch.Tensor,
                  symmetric: bool = True) -> torch.Tensor:
    """[B, K] x [B, K] simplex inputs -> [K, K] joint distribution (of the
    global batch)."""
    return _normalise_joint(mesh.all_reduce_sum(x_out.t() @ x_tf_out), symmetric)


def _mutual_information(p_i_j: torch.Tensor, lamb: float):
    k = p_i_j.shape[0]
    p_i = p_i_j.sum(dim=1, keepdim=True).expand(k, k)
    p_j = p_i_j.sum(dim=0, keepdim=True).expand(k, k)
    logs = torch.log(p_i_j + 1e-10)
    log_i = torch.log(p_i + 1e-10)
    log_j = torch.log(p_j + 1e-10)
    loss = -(p_i_j * (logs - lamb * log_j - lamb * log_i)).sum()
    loss_no_lamb = -(p_i_j * (logs - log_j - log_i)).sum()
    return loss, loss_no_lamb


def iid_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, lamb: float = 1.0):
    """Negative mutual information of the paired cluster assignments:
    (loss, loss_no_lamb), the reference's first two outputs."""
    loss, loss_no_lamb = _mutual_information(compute_joint(x_out, x_tf_out), lamb)
    return mesh.grad_share(loss), mesh.grad_share(loss_no_lamb)


def iid_losses(pairs: Sequence[Pair], lamb: float = 1.0) -> List[torch.Tensor]:
    """`iid_loss(x, y, lamb)[0]` of every (x, y) of `pairs` (the subheads of
    a cluster head), their joints summed over ranks in one collective."""
    counts = mesh.all_reduce_sum(torch.stack([x.t() @ y for x, y in pairs]))
    return [mesh.grad_share(_mutual_information(_normalise_joint(c), lamb)[0])
            for c in counts]


def _dense_counts(x_out: torch.Tensor, x_tf_out: torch.Tensor, padding: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unnormalised displacement joint [k1, k2, T, T] of [B, K, H, W]
    maps: one `F.conv2d` with the second map as the kernel, summed over B."""
    if mask is not None:
        x_out = x_out * mask
        x_tf_out = x_tf_out * mask
    # [K, B, H, W] input (N = k1, C = b) against [K, B, H, W] weight (O = k2, I = b)
    return F.conv2d(x_out.transpose(0, 1), x_tf_out.transpose(0, 1), padding=padding)


def _dense_mutual_information(p: torch.Tensor, padding: int, lamb: float) -> torch.Tensor:
    t = 2 * padding + 1
    p = p - p.min().detach() + 1e-16                     # [k1, k2, T, T]
    p = p.permute(2, 3, 0, 1)                            # [T, T, k1, k2]
    p = p / p.sum(dim=(2, 3), keepdim=True)
    p = (p + p.transpose(2, 3)) / 2.0
    p_i = p.sum(dim=2, keepdim=True)
    p_j = p.sum(dim=3, keepdim=True)
    return -(p * (torch.log(p + 1e-16) - lamb * torch.log(p_i + 1e-16)
                  - lamb * torch.log(p_j + 1e-16))).sum() / (t * t)


def iid_segmentation_losses(pairs: Sequence[Pair], padding: int = 7, lamb: float = 1.0,
                            masks: Optional[Sequence[Optional[torch.Tensor]]] = None
                            ) -> List[torch.Tensor]:
    """`iid_segmentation_loss` of every (x, y) of `pairs` (equal shapes),
    their joints summed over ranks in one collective."""
    masks = masks if masks is not None else [None] * len(pairs)
    counts = mesh.all_reduce_sum(torch.stack([_dense_counts(x, y, padding, m)
                                              for (x, y), m in zip(pairs, masks)]))
    return [mesh.grad_share(_dense_mutual_information(c, padding, lamb)) for c in counts]


def iid_segmentation_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, padding: int = 7,
                          lamb: float = 1.0, mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Dense IIC over probability maps [B, K, H, W]: the displacement joint
    p(k1, k2 | dy, dx), normalised per displacement."""
    return iid_segmentation_losses([(x_out, x_tf_out)], padding, lamb, [mask])[0]


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
    pairs, masks = [], []
    for hs in _patch_starts(h, patch_size, step):
        for ws in _patch_starts(w, patch_size, step):
            sl = (slice(None), slice(None), slice(hs, hs + patch_size),
                  slice(ws, ws + patch_size))
            pairs.append((x_out[sl], x_tf_out[sl]))
            masks.append(None if mask is None else mask[sl])
    return torch.stack(iid_segmentation_losses(pairs, padding, lamb, masks)).mean()
