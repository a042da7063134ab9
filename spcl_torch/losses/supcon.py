"""Supervised-contrastive and self-paced supervised-contrastive losses, plain
PyTorch over the full [2N, 2N] matrix.

The counterpart of `spcl_tpu/losses/supcon.py` (reference
contrastyou/losses/contrast_loss3.py):
- `supcon_loss`            <-> SupConLoss1 (:34-110), incl. `exclude_other_pos`
- `self_paced_supcon_loss` <-> SelfPacedSupConLoss (:113-222): per-pair
  self-paced weights from the pair negative log-likelihood against the age
  parameter gamma — hard (w = [l <= gamma]) or soft (w = max(1 - l/gamma, 0)),
  weights forced to 1 off the positive mask, optional `correct_grad`
  rescaling by the mean selected ratio.

Losses return (loss, SupConAux). The max-subtraction uses the global
detached max of the logits like the reference. This is the path that
`use_fused=False` selects; `ops/supcon_cuda.py` computes the same loss
without materializing the [2N, 2N] masks.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_EPS = 1e-16


class SupConAux(NamedTuple):
    downgrade_ratio: torch.Tensor  # mean self-paced weight over positive pairs
    pos_pair_count: torch.Tensor
    sim_logits: Optional[torch.Tensor] = None
    pos_mask: Optional[torch.Tensor] = None
    sp_mask: Optional[torch.Tensor] = None


def pairwise_mask_from_labels(target: torch.Tensor) -> torch.Tensor:
    """[N] int labels -> [N,N] float mask: 1 where labels match (positives)."""
    return (target[:, None] == target[None, :]).float()


def _build_masks(batch_size: int, pos_mask: Optional[torch.Tensor],
                 target: Optional[torch.Tensor], valid: Optional[torch.Tensor],
                 device):
    """Tile the NxN pos/neg masks to 2Nx2N, zero the diagonal, apply padding.
    With neither mask nor target, positives are only the view pairs."""
    if pos_mask is None:
        if target is not None:
            pos_mask = pairwise_mask_from_labels(target)
        else:
            pos_mask = torch.eye(batch_size, device=device)
    pos_mask = pos_mask.float()
    neg_mask = 1.0 - pos_mask
    pos2 = pos_mask.repeat(2, 2)
    neg2 = neg_mask.repeat(2, 2)
    not_diag = 1.0 - torch.eye(2 * batch_size, device=device)
    pos2 = pos2 * not_diag
    neg2 = neg2 * not_diag
    if valid is not None:
        v = torch.cat([valid, valid]).float()
        vv = v[:, None] * v[None, :]
        pos2 = pos2 * vv
        neg2 = neg2 * vv
    return pos2, neg2


def _sim_logits(z1: torch.Tensor, z2: torch.Tensor, temperature: float):
    z = torch.cat([z1, z2], dim=0).float()
    logits = (z @ z.T) / temperature
    return logits - logits.max().detach()


def _log_likelihood_matrix(sim_logits, pos2, neg2, exclude_other_pos: bool):
    sim_exp = torch.exp(sim_logits)
    pos_count = pos2.sum(dim=1)
    neg_count = neg2.sum(dim=1)
    pos_sum = (sim_exp * pos2).sum(dim=1, keepdim=True)
    neg_sum = (sim_exp * neg2).sum(dim=1, keepdim=True)
    if exclude_other_pos:
        neg_ratio = neg_count / torch.clamp(pos_count + neg_count, min=1.0)
        log_prob = sim_logits - torch.log(sim_exp + neg_sum / (neg_ratio + 1e-4)[:, None] + _EPS)
    else:
        log_prob = sim_logits - torch.log(pos_sum + neg_sum + _EPS)
    return log_prob, pos_count


def _reduce_over_positives(log_prob, pos2, pos_count, valid):
    row_loss = (log_prob * pos2).sum(dim=1) / torch.clamp(pos_count, min=1.0)
    if valid is None:
        return -row_loss.mean()
    v = torch.cat([valid, valid]).float()
    # rows with no positive pair (padding) contribute nothing
    row_ok = v * (pos_count > 0).float()
    return -(row_loss * row_ok).sum() / torch.clamp(row_ok.sum(), min=1.0)


def supcon_loss(z1: torch.Tensor, z2: torch.Tensor, *,
                target: Optional[torch.Tensor] = None,
                pos_mask: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                temperature: float = 0.07,
                exclude_other_pos: bool = False,
                return_matrices: bool = False):
    """SupCon/SimCLR loss over two views of N embeddings.

    z1, z2: [N, D] L2-normalized projections; target: [N] int meta-labels
    (positives = equal labels) or None for SimCLR; pos_mask: explicit [N, N]
    mask overriding `target`; valid: [N] 1/0 padding mask.
    """
    n = z1.shape[0]
    pos2, neg2 = _build_masks(n, pos_mask, target, valid, z1.device)
    sim_logits = _sim_logits(z1, z2, temperature)
    log_prob, pos_count = _log_likelihood_matrix(sim_logits, pos2, neg2, exclude_other_pos)
    loss = _reduce_over_positives(log_prob, pos2, pos_count, valid)
    aux = SupConAux(
        downgrade_ratio=torch.ones((), device=z1.device),
        pos_pair_count=pos2.sum(),
        sim_logits=sim_logits if return_matrices else None,
        pos_mask=pos2 if return_matrices else None,
    )
    return loss, aux


def self_paced_supcon_loss(z1: torch.Tensor, z2: torch.Tensor, *,
                           gamma,
                           target: Optional[torch.Tensor] = None,
                           pos_mask: Optional[torch.Tensor] = None,
                           valid: Optional[torch.Tensor] = None,
                           temperature: float = 0.07,
                           weight_update: str = "hard",
                           correct_grad: bool = False,
                           return_matrices: bool = False):
    """Self-paced SupCon: per-pair weights from the pair loss vs the age
    parameter gamma (a float or a 0-d tensor)."""
    if weight_update not in ("hard", "soft"):
        raise ValueError(weight_update)
    n = z1.shape[0]
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=z1.device)
    pos2, neg2 = _build_masks(n, pos_mask, target, valid, z1.device)
    sim_logits = _sim_logits(z1, z2, temperature)
    log_prob, pos_count = _log_likelihood_matrix(sim_logits, pos2, neg2, exclude_other_pos=False)

    # ---- self-paced weights (no gradient; reference :207-214) ----
    l_ij = -log_prob.detach()
    if weight_update == "hard":
        w = (l_ij <= gamma).float()
    else:
        w = torch.clamp(1.0 - l_ij / gamma, min=0.0)
    sp_mask = torch.maximum(w, 1.0 - pos2)  # non-positive pairs keep weight 1

    pos_total = pos2.sum()
    downgrade_ratio = (sp_mask * pos2).sum() / torch.clamp(pos_total, min=1.0)

    loss = _reduce_over_positives(log_prob * sp_mask, pos2, pos_count, valid)
    if correct_grad:
        # reference :199-201 divides by the batch ratio when it is > 0
        loss = torch.where(downgrade_ratio > 0,
                           loss / torch.clamp(downgrade_ratio, min=_EPS), loss)
    aux = SupConAux(
        downgrade_ratio=downgrade_ratio,
        pos_pair_count=pos_total,
        sim_logits=sim_logits if return_matrices else None,
        pos_mask=pos2 if return_matrices else None,
        sp_mask=sp_mask if return_matrices else None,
    )
    return loss, aux
