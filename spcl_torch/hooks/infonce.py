"""InfoNCE / self-paced InfoNCE hooks — the paper's pretraining losses, on
encoder stages.

The counterpart of the encoder path of `spcl_tpu/hooks/infonce.py`
(reference semi_seg/hooks/infonce.py:56-141, 171-195):
  features of the two views <- ctx["acts"][stage][-2n:]
  view-1 features re-flipped with the step's flip params (geometry align)
  ProjectionHead -> z (L2-normalized)
  loss = (SelfPaced)SupCon(z1, z2, target=meta_labels)

Criterion dispatch: `use_fused` "auto" or true runs `ops.supcon_cuda` —
the hand-written kernels on a CUDA tensor at EVERY batch size, their plain
per-row version on a CPU tensor; false runs the dense `losses/supcon.py`.
(`spcl_tpu`'s FUSED_MIN_ROWS crossover is a TPU measurement and does not
apply here.) `global_contrast` is accepted for config compatibility; on one
device both of its values compute the same loss.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .base import TrainerHook, label_from_contrast_on
from ..data.augment import apply_flip
from ..losses.supcon import self_paced_supcon_loss, supcon_loss
from ..models.heads import ProjectionHead
from ..models.unet import ENCODER_NAMES
from ..ops.supcon_cuda import fused_self_paced_supcon, fused_supcon
from ..schedulers.gamma import PScheduler


class INFONCEHook(TrainerHook):
    def __init__(self, *, name: str, feature_name: str, weight: float = 1.0,
                 contrast_on: str = "partition",
                 spatial_size: Optional[Tuple[int, int]] = None,
                 temperature: float = 0.07, use_fused="auto",
                 global_contrast: str = "replicated"):
        super().__init__(name, weight)
        if feature_name not in ENCODER_NAMES:
            raise NotImplementedError(
                f"decoder-stage InfoNCE ({feature_name}) is not ported yet")
        if global_contrast not in ("replicated", "row_sharded"):
            raise ValueError(global_contrast)
        self.global_contrast = global_contrast
        self.use_fused = use_fused
        self.feature_name = feature_name
        self.contrast_on = contrast_on
        self.temperature = float(temperature)
        self.spatial_size = tuple(spatial_size) if spatial_size is not None else (1, 1)

    def build(self, model, device):
        self.projector = ProjectionHead(
            input_dim=model.channel_dim(self.feature_name), output_dim=256,
            hidden_dim=256, head_type="mlp", normalize=True,
            spatial_size=self.spatial_size).to(device)
        return self.projector

    @property
    def fused(self) -> bool:
        return self.use_fused == "auto" or bool(self.use_fused)

    def _projected_views(self, ctx):
        n = ctx["n_unl"]
        feats = ctx["acts"][self.feature_name][-2 * n:]
        v1, v2 = feats[:n], feats[n:]
        # align view-1 features into the flipped frame (reference :177-179)
        v1_tf = apply_flip(v1, ctx["flip"])
        z = self.projector(torch.cat([v1_tf, v2], dim=0))
        return z[:n], z[n:]

    def _criterion(self, z1, z2, target, valid, scalars):
        if self.fused:
            loss = fused_supcon(z1, z2, target=target, valid=valid,
                                temperature=self.temperature)
        else:
            loss, _ = supcon_loss(z1, z2, target=target, valid=valid,
                                  temperature=self.temperature)
        return loss, {"loss": loss}

    def loss_fn(self, ctx, scalars):
        z1, z2 = self._projected_views(ctx)
        target = label_from_contrast_on(ctx, self.contrast_on)
        loss, metrics = self._criterion(z1, z2, target, ctx["valid"], scalars)
        return loss * self.weight, metrics


class SelfPacedINFONCEHook(INFONCEHook):
    def __init__(self, *, name: str, feature_name: str, weight: float = 1.0,
                 contrast_on: str = "partition", spatial_size=None,
                 temperature: float = 0.07, mode: str = "soft", p: float = 0.5,
                 begin_value: float = 1e6, end_value: float = 1e6,
                 correct_grad: bool = False, max_epoch: int = 80, use_fused="auto",
                 global_contrast: str = "replicated"):
        super().__init__(name=name, feature_name=feature_name, weight=weight,
                         contrast_on=contrast_on, spatial_size=spatial_size,
                         temperature=temperature, use_fused=use_fused,
                         global_contrast=global_contrast)
        if mode not in ("soft", "hard"):
            raise ValueError(mode)
        self.mode = mode
        self.correct_grad = bool(correct_grad)
        self.scheduler = PScheduler(max_epoch=max_epoch, begin_value=begin_value,
                                    end_value=end_value, p=p)

    def epoch_scalars(self, epoch: int) -> Dict[str, float]:
        # reference :133-136: gamma read then scheduler stepped each epoch
        return {"gamma": float(self.scheduler.get_value(epoch))}

    def on_epoch_end(self) -> None:
        self.scheduler.step()

    def _criterion(self, z1, z2, target, valid, scalars):
        gamma = scalars["gamma"]
        if self.fused:
            loss, ratio = fused_self_paced_supcon(
                z1, z2, target=target, valid=valid, gamma=gamma,
                temperature=self.temperature, weight_update=self.mode,
                correct_grad=self.correct_grad)
        else:
            loss, aux = self_paced_supcon_loss(
                z1, z2, target=target, valid=valid, gamma=gamma,
                temperature=self.temperature, weight_update=self.mode,
                correct_grad=self.correct_grad)
            ratio = aux.downgrade_ratio
        return loss, {"loss": loss, "sp_weight": ratio, "age_param": gamma}

    def state_dict(self):
        return {"scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state):
        self.scheduler.load_state_dict(state["scheduler"])
