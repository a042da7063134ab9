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
nu*b2 + (1-b2)*(g*g), r*mu_hat / (sqrt(nu_hat) + eps). Parameters without a
gradient (frozen stages) are skipped.

The step count is a float32 tensor on the parameters' device
(`state["step"]`, one tensor shared by the parameters that have taken the
same number of steps), and the step-count terms (b**t, RAdam's rho and r) are
computed from it on the device, in float32 as optax does; RAdam's branch at
the rectification threshold is a select. So no step reads a host value that
changes from step to step, and a step captured in a CUDA graph
(`training/steps.py`) replays as the next step. The learning rate and the
other group settings are host floats, read when a step runs (or is captured).
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
        [(t, mus, nus, indices into params)] grouped by the step-count tensor
        t the parameters share (one group in practice)."""
        b1, b2 = group["betas"]
        fresh = [p for p in params if not self.state[p]]
        if fresh:
            t0 = torch.zeros((), dtype=torch.float32, device=fresh[0].device)
            for p in fresh:
                self.state[p].update(step=t0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        by_step = {}
        for i, p in enumerate(params):
            t = self.state[p]["step"]
            by_step.setdefault(id(t), (t, []))[1].append(i)
        torch._foreach_add_([t for t, _ in by_step.values()], 1.0)
        return [(t, [mus[i] for i in ix], [nus[i] for i in ix], ix)
                for t, ix in by_step.values()]

    def load_state_dict(self, state_dict) -> None:
        """torch's, then every step count as a float32 tensor on its
        parameter's device, one tensor for the parameters of one group that
        have taken the same number of steps (a checkpoint may hold ints)."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            shared = {}
            for p in group["params"]:
                state = self.state.get(p)
                if state and "step" in state:
                    n = float(state["step"])
                    if n not in shared:
                        shared[n] = torch.tensor(n, dtype=torch.float32, device=p.device)
                    state["step"] = shared[n]


def _adaptive(mu_hat, nu_hat, eps, r=None):
    """r * mu_hat / (sqrt(nu_hat) + eps), elementwise over the lists (r a
    float32 scalar tensor)."""
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


def _bias_correction(b: float, t: torch.Tensor) -> torch.Tensor:
    """1 - b**t in float32 (t a float32 step-count tensor)."""
    return 1.0 - torch.pow(float(_F32(b)), t)


def radam_terms(b2: float, threshold: float, t: torch.Tensor):
    """(1 - b2**t, r, rectified) of optax.scale_by_radam at step count t, on
    t's device in float32: r = sqrt((rho-4)(rho-2)rho_inf /
    ((rho_inf-4)(rho_inf-2)rho)) where rho >= threshold, else 1, and
    `rectified` 1.0 there, else 0.0 (r is NaN below rho = 4, so the select
    drops it)."""
    ro_inf = _F32(2.0 / (1.0 - b2) - 1.0)
    b2t = torch.pow(float(_F32(b2)), t)
    ro = float(ro_inf) - 2.0 * t * b2t / (1.0 - b2t)
    rectified = ro >= threshold
    r = torch.sqrt((ro - 4.0) * (ro - 2.0) * float(ro_inf)
                   / (float((ro_inf - _F32(4)) * (ro_inf - _F32(2))) * ro))
    return 1.0 - b2t, torch.where(rectified, r, torch.ones_like(r)), rectified.float()


class RAdam(_Chain):
    """Rectified Adam, optax.scale_by_radam semantics. Below the threshold the
    update is mu_hat, above it r * mu_hat / (sqrt(nu_hat) + eps). Both are
    computed (r is 1 below the threshold, so the adaptive update is finite)
    and the select is adaptive * k + mu_hat * (1 - k) with k the 0/1
    `rectified`, which is the bits of the branch taken."""

    def _scale(self, group, params, grads):
        b1, b2 = group["betas"]
        parts = []
        for t, mus, nus, ix in self._moments(group, params, grads):
            bc2, r, rectified = radam_terms(b2, group["threshold"], t)
            mu_hat = torch._foreach_div(mus, _bias_correction(b1, t))
            nu_hat = torch._foreach_div(nus, bc2)
            adaptive = _adaptive(mu_hat, nu_hat, group["eps"], r)
            torch._foreach_mul_(adaptive, rectified)
            parts.append((ix, torch._foreach_add(
                adaptive, torch._foreach_mul(mu_hat, 1.0 - rectified))))
        return _scatter(len(params), parts)


class Adam(_Chain):
    """optax.scale_by_adam (eps_root 0)."""

    def _scale(self, group, params, grads):
        b1, b2 = group["betas"]
        parts = []
        for t, mus, nus, ix in self._moments(group, params, grads):
            mu_hat = torch._foreach_div(mus, _bias_correction(b1, t))
            nu_hat = torch._foreach_div(nus, _bias_correction(b2, t))
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
