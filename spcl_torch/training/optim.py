"""Optimizer factory: RAdam with torch-style L2 weight decay.

The counterpart of `spcl_tpu/training/optim.py::build_optimizer`, whose
chain is add_decayed_weights(wd) -> scale_by_radam() -> scale_by_lr: the
weight decay is added to the gradient BEFORE the adaptive step. The update
is written out here to follow `optax.scale_by_radam` exactly rather than
`torch.optim.RAdam`, which differs in where eps enters the adaptive term
(optax: sqrt(v_hat) + eps; torch: (sqrt(v) + eps) / sqrt(bias correction)) —
visible at this repo's lr=1e-7 with tiny second moments. The step-count
scalars are computed in float32, as optax does.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


class RAdam(torch.optim.Optimizer):
    """Rectified Adam, optax semantics; `weight_decay` is L2 on the gradient."""

    def __init__(self, params: Iterable, lr: float = 1e-7, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            f32 = np.float32
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * (g * g))
                state["step"] += 1
                t = state["step"]
                ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
                b2t = f32(b2) ** f32(t)
                ro = ro_inf - f32(2) * f32(t) * b2t / (f32(1) - b2t)
                mu_hat = mu / float(f32(1) - f32(b1) ** f32(t))
                if ro >= group["threshold"]:
                    nu_hat = nu / float(f32(1) - b2t)
                    r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf
                                / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro))
                    update = float(r) * mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                else:
                    update = mu_hat
                p.add_(-group["lr"] * update)
        return loss


def build_optimizer(params: Iterable, *, name: str = "RAdam", lr: float = 1e-7,
                    weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """The optimizer of the config's `Optim` block. The learning rate is set
    per epoch by the trainer (schedulers/lr.py)."""
    if name.lower() != "radam":
        raise KeyError(f"optimizer {name!r} is not ported yet (RAdam only)")
    return RAdam(params, lr=lr, weight_decay=weight_decay)
