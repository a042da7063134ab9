"""MINE mutual-information estimator hook.

The counterpart of `spcl_tpu/hooks/mine.py` (reference
semi_seg/mi_estimator/mineestimator.py:9-50 + MineTrainer,
semi_seg/trainers/trainer.py:98-110): a statistics network T over the
channel-concatenated feature maps of the two views bounds their mutual
information (Deep-InfoMax JSD form):
    loss = mean(softplus(T(f1, roll(f2)))) + mean(softplus(T(f1, f2)))
(Em - Ej with Ej = -mean(softplus(T)), the sign convention spcl_tpu keeps);
the metric `mi` is -loss.

The statistics net keeps spcl_tpu's deviation from the reference: GroupNorm
(flax's, eps 1e-6) where the reference has BatchNorm.

In a multi-rank run the roll is over the GLOBAL batch (rank r's last row
pairs with rank r+1's first, the last rank's with rank 0's, through a
differentiable gather of the first rows) and both means are global means.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .base import TrainerHook
from ..data.augment import apply_flip
from ..parallel import mesh


class MineStatNet(nn.Module):
    """conv3x3 -> GroupNorm -> ReLU, twice, global max, dense -> [B]."""

    def __init__(self, in_channels: int, hidden: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.gn0 = nn.GroupNorm(min(32, hidden), hidden, eps=1e-6)
        self.conv1 = nn.Conv2d(hidden, hidden // 2, 3, padding=1)
        self.gn1 = nn.GroupNorm(min(32, hidden // 2), hidden // 2, eps=1e-6)
        self.fc = nn.Linear(hidden // 2, 1)

    def forward(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([f1, f2], dim=1).float()
        x = F.relu(self.gn0(self.conv0(x)))
        x = F.relu(self.gn1(self.conv1(x)))
        return self.fc(x.amax(dim=(2, 3)))[:, 0]


def roll_back_one(f: torch.Tensor) -> torch.Tensor:
    """This rank's rows of torch.roll(f, -1, 0) over the global batch."""
    if not mesh.active():
        return torch.roll(f, shifts=-1, dims=0)
    firsts = mesh.all_gather_cat(f[:1])
    after = firsts[(mesh.rank() + 1) % mesh.world_size()]
    return torch.cat([f[1:], after[None]], dim=0)


def _global_mean(x: torch.Tensor) -> torch.Tensor:
    # every rank holds the same number of rows of the padded global batch
    return mesh.global_sum(x.mean() / mesh.world_size())


class MineTrainHook(TrainerHook):
    def __init__(self, *, name: str, feature_name: str, weight: float = 1.0):
        super().__init__(name, weight)
        self.feature_name = feature_name

    def build(self, model, device):
        ch = model.channel_dim(self.feature_name)
        self.projector = MineStatNet(2 * ch, ch).to(device)
        return self.projector

    def loss_fn(self, ctx, scalars):
        n = ctx["n_unl"]
        feats = ctx["acts"][self.feature_name][-2 * n:]
        f1 = apply_flip(feats[:n], ctx["flip"])  # align the geometry, as infonce does
        f2 = feats[n:]
        f2_prime = roll_back_one(f2)  # shuffled marginal pairing
        ej = -_global_mean(F.softplus(self.projector(f1, f2)))
        em = _global_mean(F.softplus(self.projector(f1, f2_prime)))
        loss = em - ej
        return loss * self.weight, {"mi": -loss.detach()}
