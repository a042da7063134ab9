"""Mean-teacher hook.

The counterpart of `spcl_tpu/hooks/mt.py` (reference semi_seg/hooks/mt.py:
13-55): the EMA teacher (`models/ema.py`, kept by the semi step) predicts
the plain unlabeled batch; the prediction, carried into the transformed
frame with the step's flips, is the target of an MSE against the student's
prediction on the transformed batch. Both sides are softmaxed, as
spcl_tpu does (the reference MSEs the teacher's raw logits, mt.py:49-52).

`alpha` is the EMA's alpha_max. The port hands it to the step; spcl_tpu's
trainer never does (trainer.py:417-421 builds the step without
`ema_alpha`), so there it is 0.999 whatever the config says — the shipped
configs set 0.999, where the two agree.
"""
from __future__ import annotations

import torch

from .base import TrainerHook
from .consistency import masked_prob_mse


class MeanTeacherTrainerHook(TrainerHook):
    needs_teacher = True

    def __init__(self, name: str = "mt", weight: float = 1.0, alpha: float = 0.999):
        super().__init__(name, weight)
        self.alpha = float(alpha)

    def loss_fn(self, ctx, scalars):
        student = torch.softmax(ctx["unlabeled_tf_logits"], dim=1)
        teacher = torch.softmax(ctx["teacher_logits_tf"], dim=1).detach()
        loss = masked_prob_mse(student, teacher, ctx["valid"])
        return loss * self.weight, {"loss": loss.detach()}
