"""MIDL-paper regulariser: patchified dense IIC on the prediction maps.

The counterpart of `spcl_tpu/hooks/midl.py` (reference MIDLPaperEpocher via
MIDLTrainer, semi_seg/trainers/trainer.py:39-61): IIDSegmentationSmallPathLoss
between softmax(the student on the transformed batch) and softmax(the
student's prediction flipped into that frame); the factory pairs it with the
consistency hook. Under a mesh the patches' joints are of the global batch
(`losses/iic.py`, one collective a step).
"""
from __future__ import annotations

import torch

from .base import TrainerHook
from ..losses.iic import iid_segmentation_small_patch_loss


class MIDLPaperTrainerHook(TrainerHook):
    def __init__(self, name: str = "midl", weight: float = 1.0,
                 padding: int = 7, patch_size: int = 32):
        super().__init__(name, weight)
        self.padding = int(padding)
        self.patch_size = int(patch_size)

    def loss_fn(self, ctx, scalars):
        p1 = torch.softmax(ctx["unlabeled_tf_logits"], dim=1)
        p2 = torch.softmax(ctx["unlabeled_logits_tf"], dim=1)
        loss = iid_segmentation_small_patch_loss(p1, p2, padding=self.padding,
                                                 patch_size=self.patch_size)
        return loss * self.weight, {"mi": loss.detach()}
