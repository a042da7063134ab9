"""The EMA teacher of the mean-teacher hooks.

The counterpart of `spcl_tpu/models/ema.py` and of the semi step's EMA
(`spcl_tpu/training/steps.py::_ema_after_step`, :97-102), which replace
deepclustering2's `ema_updater` (reference semi_seg/hooks/mt.py:13-55):

    teacher <- alpha * teacher + (1 - alpha) * student,
    alpha = min(1 - 1/(step + 2), alpha_max)

after every optimizer step, `step` the number of steps before it (0 at the
first), in float32 as the JAX step computes it. `ramped_alpha` is spcl_tpu's
module-level ramp, min(1 - 1/(step + 1), alpha_max), which no step uses.

The teacher is a deep copy of the student UNet, its parameters frozen and
never given to the optimizer. It predicts in train mode, with batch
statistics, as spcl_tpu's `apply_teacher` does (`train=True,
update_stats=False`), and its BatchNorm running statistics never move
(`models/norm.py::freeze_statistics`). Only parameters are averaged, as the
JAX teacher holds parameters only.

In a multi-rank run the teacher's norms are copies of the student's
`CrossRankBatchNorm2d`: its train-mode forward uses the batch statistics of
the global batch, as the student's does, and every rank updates its teacher
from the same student weights, so the replicas stay equal.
"""
from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from .norm import freeze_statistics

_F32 = np.float32


@torch.no_grad()
def ema_update(teacher_params: Sequence[torch.Tensor], student_params: Sequence[torch.Tensor],
               alpha: float) -> None:
    """teacher <- alpha * teacher + (1 - alpha) * student, in place, with the
    products rounded before the sum (the op order of the JAX update)."""
    teacher_params, student_params = list(teacher_params), list(student_params)
    alpha = _F32(alpha)
    scaled = torch._foreach_mul(student_params, float(_F32(1) - alpha))
    torch._foreach_mul_(teacher_params, float(alpha))
    torch._foreach_add_(teacher_params, scaled)


def semi_step_alpha(step: int, alpha_max: float = 0.999) -> float:
    """The semi step's alpha: min(1 - 1/(step + 2), alpha_max) in float32."""
    return float(min(_F32(1) - _F32(1) / (_F32(step) + _F32(2)), _F32(alpha_max)))


def ramped_alpha(global_step: int, alpha_max: float = 0.999) -> float:
    """spcl_tpu's `ramped_alpha`: min(1 - 1/(step + 1), alpha_max) in float32."""
    return float(min(_F32(1) - _F32(1) / (_F32(global_step) + _F32(1)), _F32(alpha_max)))


class EMATeacher:
    """A frozen copy of `student` with its step count, updated by `update`."""

    def __init__(self, student: nn.Module, alpha_max: float = 0.999):
        self.model = copy.deepcopy(student)
        for p in self.model.parameters():
            p.requires_grad_(False)
        freeze_statistics(self.model)
        self.alpha_max = float(alpha_max)
        self.step = 0

    @torch.no_grad()
    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """The teacher's prediction in train mode (batch statistics)."""
        self.model.train()
        return self.model(images)["logits"]

    def update(self, student: nn.Module) -> float:
        """One EMA step after the optimizer's; returns the alpha it used."""
        alpha = semi_step_alpha(self.step, self.alpha_max)
        ema_update(self.model.parameters(), student.parameters(), alpha)
        self.step += 1
        return alpha

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(), "step": self.step}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.step = int(state["step"])
