"""Entropy-minimisation hook.

The counterpart of `spcl_tpu/hooks/entmin.py` (reference
semi_seg/hooks/entmin.py:8-34): the mean Shannon entropy of
softmax(unlabeled_logits_tf) over the pixels of valid slices (of the global
batch in a multi-rank run).
"""
from __future__ import annotations

import torch

from .base import TrainerHook
from ..parallel import mesh


class EntropyMinTrainerHook(TrainerHook):
    def __init__(self, name: str = "entmin", weight: float = 1.0):
        super().__init__(name, weight)

    def loss_fn(self, ctx, scalars):
        probs = torch.softmax(ctx["unlabeled_logits_tf"], dim=1)
        ent = -(probs * torch.log(probs + 1e-16)).sum(dim=1)  # [N, h, w]
        mask = ctx["valid"][:, None, None]
        count = torch.clamp(mesh.global_count(mask) * ent.shape[1] * ent.shape[2], min=1.0)
        loss = mesh.global_sum((ent * mask).sum() / count)
        return loss * self.weight, {"loss": loss.detach()}
