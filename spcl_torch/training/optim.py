"""Optimizer factory: the optax chains of spcl_tpu as multi-tensor updates.

The counterpart of `spcl_tpu/training/optim.py::build_optimizer`, whose
chain is

    clip_by_global_norm(grad_clip)      when grad_clip is set
    add_decayed_weights(weight_decay)   before the step (torch L2), but
    scale_by_{radam,adam,trace}         after it for adamw
    scale_by_learning_rate(lr)

for `radam` (optax.scale_by_radam), `adam` and `adamw` (optax.scale_by_adam)
and `sgd` (optax.trace(momentum, nesterov), the identity at momentum 0). The
updates are written out to follow optax rather than `torch.optim`, which
differs where eps enters the adaptive term (optax: sqrt(v_hat) + eps;
torch: (sqrt(v) + eps) / sqrt(bias correction)) — visible at this repo's
lr=1e-7 with tiny second moments.

Each update runs over all parameters of a group at once with
`torch._foreach_*` ops (one launch per op, not per parameter, on the card),
in the op order of a per-parameter loop: mu*b1 + (1-b1)*g,
nu*b2 + (1-b2)*(g*g), r*mu_hat / (sqrt(nu_hat) + eps). The step-count
scalars are computed once per step on the host, in float32 as optax does.
Parameters without a gradient (frozen stages) are skipped.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

_F32 = np.float32


class _Chain(torch.optim.Optimizer):
    """One optax chain; subclasses define `_scale` (the scale_by_* link)."""

    decay_after_scale = False  # adamw adds the decayed weights after the step

    def __init__(self, params: Iterable, lr: float = 1e-7, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, threshold: float = 5.0,
                 momentum: float = 0.9, nesterov: bool = False,
                 grad_clip: Optional[float] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      threshold=threshold, momentum=momentum,
                                      nesterov=nesterov))
        self.grad_clip = grad_clip

    def _clip_factor(self) -> Optional[torch.Tensor]:
        """optax.clip_by_global_norm over every parameter of every group: the
        factor max_norm / ||g|| where the norm reaches max_norm, else 1."""
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not self.grad_clip or not grads:
            return None
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        return torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        factor = self._clip_factor()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if factor is not None:
                grads = torch._foreach_mul(grads, factor)
            wd = group["weight_decay"]
            if wd and not self.decay_after_scale:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
            updates = self._scale(group, params, grads)
            if wd and self.decay_after_scale:
                updates = torch._foreach_add(updates, torch._foreach_mul(params, wd))
            torch._foreach_add_(params, torch._foreach_mul(updates, -group["lr"]))
        return loss

    def _scale(self, group, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def _moments(self, group, params, grads):
        """Advance the first and second moments and the step counts; returns
        [(t, mus, nus, indices into params)] grouped by step count t (one
        group in practice)."""
        b1, b2 = group["betas"]
        for p in params:
            state = self.state[p]
            if not state:
                state["step"] = 0
                state["mu"] = torch.zeros_like(p)
                state["nu"] = torch.zeros_like(p)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        by_step = {}
        for i, p in enumerate(params):
            self.state[p]["step"] += 1
            by_step.setdefault(self.state[p]["step"], []).append(i)
        return [(t, [mus[i] for i in ix], [nus[i] for i in ix], ix)
                for t, ix in by_step.items()]


def _adaptive(mu_hat, nu_hat, eps, r=None):
    """r * mu_hat / (sqrt(nu_hat) + eps), elementwise over the lists."""
    den = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(den, eps)
    num = mu_hat if r is None else torch._foreach_mul(mu_hat, r)
    return torch._foreach_div(num, den)


def _scatter(n, parts):
    out = [None] * n
    for ix, values in parts:
        for i, v in zip(ix, values):
            out[i] = v
    return out


class RAdam(_Chain):
    """Rectified Adam, optax.scale_by_radam semantics."""

    def _scale(self, group, params, grads):
        b1, b2 = group["betas"]
        ro_inf = _F32(2.0 / (1.0 - b2) - 1.0)
        parts = []
        for t, mus, nus, ix in self._moments(group, params, grads):
            b2t = _F32(b2) ** _F32(t)
            ro = ro_inf - _F32(2) * _F32(t) * b2t / (_F32(1) - b2t)
            mu_hat = torch._foreach_div(mus, float(_F32(1) - _F32(b1) ** _F32(t)))
            if ro >= group["threshold"]:
                nu_hat = torch._foreach_div(nus, float(_F32(1) - b2t))
                r = np.sqrt((ro - _F32(4)) * (ro - _F32(2)) * ro_inf
                            / ((ro_inf - _F32(4)) * (ro_inf - _F32(2)) * ro))
                parts.append((ix, _adaptive(mu_hat, nu_hat, group["eps"], float(r))))
            else:
                parts.append((ix, mu_hat))
        return _scatter(len(params), parts)


class Adam(_Chain):
    """optax.scale_by_adam (eps_root 0)."""

    def _scale(self, group, params, grads):
        b1, b2 = group["betas"]
        parts = []
        for t, mus, nus, ix in self._moments(group, params, grads):
            mu_hat = torch._foreach_div(mus, float(_F32(1) - _F32(b1) ** _F32(t)))
            nu_hat = torch._foreach_div(nus, float(_F32(1) - _F32(b2) ** _F32(t)))
            parts.append((ix, _adaptive(mu_hat, nu_hat, group["eps"])))
        return _scatter(len(params), parts)


class AdamW(Adam):
    """Adam with the decayed weights added after the adaptive step."""
    decay_after_scale = True


class SGD(_Chain):
    """optax.trace(decay=momentum, nesterov): trace = g + momentum * trace;
    the update is the trace, or g + momentum * trace with nesterov. Momentum
    0 is plain gradient descent (optax.identity)."""

    def _scale(self, group, params, grads):
        m = group["momentum"]
        if not m:
            return list(grads)
        for p in params:
            if "trace" not in self.state[p]:
                self.state[p]["trace"] = torch.zeros_like(p)
        traces = [self.state[p]["trace"] for p in params]
        torch._foreach_mul_(traces, m)
        torch._foreach_add_(traces, grads)
        if group["nesterov"]:
            return torch._foreach_add(grads, torch._foreach_mul(traces, m))
        return traces


OPTIMIZERS = {"radam": RAdam, "adam": Adam, "adamw": AdamW, "sgd": SGD}


def build_optimizer(params: Iterable, *, name: str = "RAdam", lr: float = 1e-7,
                    weight_decay: float = 0.0, grad_clip: Optional[float] = None,
                    momentum: float = 0.9, nesterov: bool = False) -> torch.optim.Optimizer:
    """The optimizer of the config's `Optim` block (name, weight_decay,
    momentum, nesterov; `grad_clip` as spcl_tpu's `build_optimizer` takes it,
    which its trainer does not pass either). The learning rate is set per
    epoch by the trainer (schedulers/lr.py)."""
    key = name.lower()
    if key not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}")
    return OPTIMIZERS[key](params, lr=lr, weight_decay=weight_decay, grad_clip=grad_clip,
                           momentum=momentum, nesterov=nesterov)
