"""MixUp hook.

The counterpart of `spcl_tpu/hooks/mixup.py` (reference
semi_seg/hooks/mixup.py:19-94): a Beta(alpha, alpha) mix of the two labeled
views and of their one-hot targets under one permutation, the student's
prediction on the mixed images held to the mixed targets by KL. The forward
runs through ctx["apply_student"]: train mode, BatchNorm statistics frozen,
gradients flowing to the student — what spcl_tpu's step guarantees for
auxiliary forwards whatever `enable_bn` says.

lambda and the permutation are this hook's draw (`sample`) from the step's
generator. Beta(1, 1), the only alpha a config reaches (the factory passes
none), is U(0, 1); another alpha raises, as no Beta draw takes a generator.
"""
from __future__ import annotations

import torch

from .base import TrainerHook
from ..losses.kl import kl_div


class MixUpHook(TrainerHook):
    def __init__(self, name: str = "mix_reg", weight: float = 1.0, alpha: float = 1.0,
                 enable_bn: bool = True):
        super().__init__(name, weight)
        if float(alpha) != 1.0:
            raise NotImplementedError("MixUpHook draws lambda from U(0, 1) = Beta(1, 1); "
                                      f"alpha={alpha} is not ported")
        self.alpha = float(alpha)
        self.enable_bn = bool(enable_bn)

    def sample(self, generator, ctx):
        img = ctx["labeled_image"]
        n = 2 * img.shape[0]
        return {"lam": torch.rand((), generator=generator, device=img.device),
                "perm": torch.randperm(n, generator=generator, device=img.device)}

    def loss_fn(self, ctx, scalars):
        x = torch.cat([ctx["labeled_image"], ctx["labeled_image_tf"]], dim=0)
        y = torch.cat([ctx["labeled_onehot"], ctx["labeled_onehot_tf"]], dim=0)
        draw = ctx["draws"][self.name]
        lam, perm = draw["lam"], draw["perm"]
        mixed_x = lam * x + (1 - lam) * x[perm]
        mixed_y = lam * y + (1 - lam) * y[perm]
        logits = ctx["apply_student"](mixed_x)
        loss = kl_div(torch.softmax(logits, dim=1), mixed_y)
        return loss * self.weight, {"loss": loss.detach()}
