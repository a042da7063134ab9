"""Supervised segmentation criterion + entropy (`spcl_tpu/losses/kl.py`,
which replaces deepclustering2's `KL_div` / `Entropy`).

KL_div(pred_probs, onehot_target) = KL(target || pred)
    = sum_c target_c * (log(target_c + eps) - log(pred_c + eps)),
reduced by a mean over the batch and spatial dims. The class axis is 1
(NCHW) by default.
"""
from __future__ import annotations

import torch

_EPS = 1e-16


def kl_div(pred_probs: torch.Tensor, target_probs: torch.Tensor,
           class_axis: int = 1) -> torch.Tensor:
    """KL(target || pred). Both inputs are probability maps over `class_axis`."""
    kl = target_probs * (torch.log(target_probs + _EPS) - torch.log(pred_probs + _EPS))
    return kl.sum(dim=class_axis).mean()


def cross_entropy_onehot(logits: torch.Tensor, onehot_target: torch.Tensor,
                         class_axis: int = 1) -> torch.Tensor:
    """The stable form of kl_div(softmax(logits), onehot)."""
    logp = torch.log_softmax(logits, dim=class_axis)
    return -(onehot_target * logp).sum(dim=class_axis).mean()


def entropy_loss(probs: torch.Tensor, class_axis: int = 1) -> torch.Tensor:
    """Mean Shannon entropy of probability maps (entropy minimisation)."""
    return -(probs * torch.log(probs + _EPS)).sum(dim=class_axis).mean()
