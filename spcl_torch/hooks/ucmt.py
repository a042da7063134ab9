"""Uncertainty-aware mean teacher (UC-MT).

The counterpart of `spcl_tpu/hooks/ucmt.py` (reference
UCMeanTeacherEpocher): the per-pixel MSE between the student's and the
teacher's predictions, kept where the teacher is certain — the entropy of
the mean of `num_noise_samples` teacher predictions on noise-perturbed
inputs, over log(C), at most the ramped threshold. The noise is this hook's
draw (`sample`): [S, N, C_in, H, W] standard normals for the global batch,
scaled by `noise_std`; in a multi-rank run each rank keeps its rows, and the
loss and `uc_ratio` are global.
The teacher passes run one per noise sample, in train mode with the
teacher's statistics frozen, as spcl_tpu's unrolled loop does.
"""
from __future__ import annotations

import math

import torch

from .base import TrainerHook, global_rows, own_rows
from ..data.augment import apply_flip
from ..parallel import mesh
from ..schedulers.gamma import RampScheduler


class UCMeanTeacherTrainerHook(TrainerHook):
    needs_teacher = True

    def __init__(self, name: str = "ucmt", weight: float = 1.0, alpha: float = 0.999,
                 num_noise_samples: int = 8, noise_std: float = 0.05,
                 threshold_begin: float = 0.75, threshold_end: float = 0.75,
                 max_epoch: int = 100):
        super().__init__(name, weight)
        self.alpha = float(alpha)
        self.num_noise_samples = int(num_noise_samples)
        self.noise_std = float(noise_std)
        self.threshold = RampScheduler(begin_epoch=0, max_epoch=max_epoch,
                                       min_value=threshold_begin, max_value=threshold_end)

    def epoch_scalars(self, epoch: int):
        return {"threshold": float(self.threshold.get_value(epoch))}

    def step_schedulers(self):
        self.threshold.step()

    def sample(self, generator, ctx):
        img = ctx["unlabeled_image"]
        n_global, _ = global_rows(ctx, img.shape[0])
        shape = (self.num_noise_samples, n_global) + tuple(img.shape[1:])
        return {"noise": torch.randn(shape, generator=generator, device=img.device)}

    def loss_fn(self, ctx, scalars):
        student = torch.softmax(ctx["unlabeled_tf_logits"], dim=1)
        teacher = torch.softmax(ctx["teacher_logits_tf"], dim=1).detach()
        per_pixel = ((student - teacher) ** 2).mean(dim=1)  # [N, h, w]

        img = ctx["unlabeled_image"]
        noise = own_rows(ctx["draws"][self.name]["noise"], ctx, img.shape[0], axis=1)
        with torch.no_grad():
            preds = [torch.softmax(apply_flip(ctx["apply_teacher"](img + self.noise_std * z),
                                              ctx["flip"]), dim=1)
                     for z in noise]
            avg = torch.stack(preds).mean(dim=0)
            c = avg.shape[1]
            entropy = -(avg * torch.log(avg + 1e-16)).sum(dim=1) / math.log(float(c))
            gate = (entropy <= scalars["threshold"]).float()

        v = ctx["valid"][:, None, None]
        count = torch.clamp(mesh.global_count(v) * per_pixel.shape[1] * per_pixel.shape[2],
                            min=1.0)
        loss = mesh.global_sum((per_pixel * gate * v).sum() / count)
        uc_ratio = mesh.all_reduce_sum((gate * v).sum()) / count
        return loss * self.weight, {"loss": loss.detach(), "uc_ratio": uc_ratio,
                                    "uc_weight": scalars["threshold"]}

    def state_dict(self):
        return {"threshold": self.threshold.state_dict()}

    def load_state_dict(self, state):
        self.threshold.load_state_dict(state["threshold"])
