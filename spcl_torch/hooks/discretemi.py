"""Discrete mutual-information (IIC) hook.

The counterpart of `spcl_tpu/hooks/discretemi.py` (reference
semi_seg/hooks/discretemi.py:14-114): a multi-subhead cluster head at a UNet
stage — on an encoder stage the pooled `ClusterHead` + IIDLoss, on a decoder
stage the `DenseClusterHead` + IIDSegmentationLoss with a displacement
padding — the loss averaged over subheads. Under a mesh the subheads' joints
are of the global batch (`losses/iic.py`, one collective a step). View-1 features are flipped into
the transformed frame before the head. `build` reads the stage's channels
from `model.channel_dim`.
"""
from __future__ import annotations

import torch

from .base import TrainerHook
from ..data.augment import apply_flip
from ..losses.iic import iid_losses, iid_segmentation_losses
from ..models.heads import ClusterHead, DenseClusterHead
from ..models.stages import is_encoder_stage


class DiscreteMITrainHook(TrainerHook):
    def __init__(self, *, name: str, feature_name: str, weight: float = 1.0,
                 num_clusters: int = 20, num_subheads: int = 5, padding: int = None):
        super().__init__(name, weight)
        self.feature_name = feature_name
        self.is_encoder = is_encoder_stage(feature_name)
        self.padding = int(padding or 0)
        self.num_clusters = int(num_clusters)
        self.num_subheads = int(num_subheads)

    def build(self, model, device):
        head = ClusterHead if self.is_encoder else DenseClusterHead
        self.projector = head(model.channel_dim(self.feature_name),
                              num_clusters=self.num_clusters, num_subheads=self.num_subheads,
                              head_type="linear", temperature=1.0).to(device)
        return self.projector

    def loss_fn(self, ctx, scalars):
        n = ctx["n_unl"]
        feats = ctx["acts"][self.feature_name][-2 * n:]
        v1_tf = apply_flip(feats[:n], ctx["flip"])
        probs = self.projector(torch.cat([v1_tf, feats[n:]], dim=0))
        # [S, 2n, K] (encoder) or [S, 2n, K, h, w] (decoder)
        p1, p2 = probs[:, :n], probs[:, n:]
        if self.is_encoder:
            losses = iid_losses(list(zip(p1, p2)))
        else:
            losses = iid_segmentation_losses(list(zip(p1, p2)), padding=self.padding)
        loss = torch.stack(losses).mean()
        return loss * self.weight, {"mi": loss.detach()}
