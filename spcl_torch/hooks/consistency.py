"""Consistency (Pi-model / UDA) hook.

The counterpart of `spcl_tpu/hooks/consistency.py` (reference
semi_seg/hooks/consistency.py:8-35): MSE between softmax(unlabeled_tf_logits)
and the detached softmax(unlabeled_logits_tf), over valid slices, the mean
taken over valid * C * h * w elements. Class axis 1 (NCHW).
"""
from __future__ import annotations

import torch

from .base import TrainerHook
from ..parallel import mesh


def masked_prob_mse(student: torch.Tensor, target: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """sum((student - target)^2 over valid slices) / (n_valid * C * h * w),
    on [N, C, h, w] probability maps. In a multi-rank run n_valid counts the
    global batch and the value is the global mean (`mesh.global_sum`)."""
    mask = valid[:, None, None, None]
    denom = torch.clamp(mesh.global_count(mask) * student.shape[1] * student.shape[2]
                        * student.shape[3], min=1.0)
    return mesh.global_sum((((student - target) ** 2) * mask).sum() / denom)


class ConsistencyTrainerHook(TrainerHook):
    def __init__(self, name: str = "consistency", weight: float = 1.0):
        super().__init__(name, weight)

    def loss_fn(self, ctx, scalars):
        student = torch.softmax(ctx["unlabeled_tf_logits"], dim=1)
        target = torch.softmax(ctx["unlabeled_logits_tf"], dim=1).detach()
        loss = masked_prob_mse(student, target, ctx["valid"])
        return loss * self.weight, {"loss": loss.detach()}
