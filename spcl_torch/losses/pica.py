"""PICA partition-uncertainty losses (`spcl_tpu/losses/pica.py`; reference
contrastyou/losses/pica_loss.py:9-84): cosine agreement between the
class-assignment columns of the two views plus a negative-entropy term on
the class marginal."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pui_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, lamb: float = 2.0) -> torch.Tensor:
    """[B, K] simplex inputs."""
    k = x_out.shape[1]
    c1 = F.normalize(x_out.t(), dim=1, eps=1e-12)   # [K, B]: rows are class columns
    c2 = F.normalize(x_tf_out.t(), dim=1, eps=1e-12)
    agreement = (c1 * c2).sum(dim=1)                # the diagonal of c1 @ c2^T
    loss_ce = -torch.log(agreement + 1e-10).mean()
    marginal = x_out.mean(dim=0)
    marginal = marginal / marginal.sum()
    loss_ne = (marginal * torch.log(marginal + 1e-10)).sum() + math.log(float(k))
    return loss_ce + lamb * loss_ne


def pui_seg_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, lamb: float = 2.0) -> torch.Tensor:
    """Dense variant on [B, K, H, W]: every pixel is a sample."""
    k = x_out.shape[1]
    return pui_loss(x_out.movedim(1, -1).reshape(-1, k),
                    x_tf_out.movedim(1, -1).reshape(-1, k), lamb)
