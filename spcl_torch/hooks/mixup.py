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
none), is drawn as U(0, 1); any other alpha > 0 as Beta(alpha, alpha) by
`sample_beta`, since PyTorch's gamma and beta samplers take no generator.

In a multi-rank run the permutation is over the global 2N rows of
[view 1; view 2] (spcl_tpu hooks/mixup.py:31): each rank mixes its own rows
of that concatenation with the rows `perm` names, gathered without a
gradient, and the KL term is a global mean.
"""
from __future__ import annotations

import math

import torch

from .base import TrainerHook
from ..losses.kl import kl_div
from ..parallel import mesh


# candidates drawn at once per gamma variate: Marsaglia-Tsang accepts each
# with probability >= 0.95, so one round almost always suffices
_CANDIDATES = 8


def _log_gamma(generator: torch.Generator, alpha: float, shape, device) -> torch.Tensor:
    """log of Gamma(alpha, 1) variates of `shape` (float32) from `generator`:
    Marsaglia and Tsang's rejection method (ACM TOMS 26(3), 2000) for
    alpha >= 1, from the generator's normal and uniform draws; for alpha < 1
    a Gamma(alpha + 1) variate times U^(1/alpha), added in logs so that a
    small alpha does not underflow. Each variate is the first accepted of
    `_CANDIDATES` candidates; a round that accepts none for some variate
    draws another round for all (one host read a round)."""
    a = alpha if alpha >= 1.0 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    while not bool(done.all()):
        x = torch.randn(shape + (_CANDIDATES,), generator=generator, device=device)
        u = torch.rand(shape + (_CANDIDATES,), generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.clamp(v, min=1e-30))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        first = torch.argmax(ok.to(torch.uint8), dim=-1, keepdim=True)
        value = (math.log(d) + log_v).gather(-1, first).squeeze(-1)
        take = ~done & ok.any(dim=-1)
        out = torch.where(take, value, out)
        done = done | take
    if alpha < 1.0:
        out = out + torch.log(torch.rand(shape, generator=generator, device=device)) / alpha
    return out


def sample_beta(generator: torch.Generator, a: float, b: float, shape=(),
                device=None) -> torch.Tensor:
    """Beta(a, b) variates (float32) of `shape` from `generator`, as
    X / (X + Y) with X ~ Gamma(a), Y ~ Gamma(b): sigmoid(log X - log Y)."""
    if not (float(a) > 0 and float(b) > 0):
        raise ValueError(f"Beta parameters must be > 0, got {a}, {b}")
    shape = tuple(shape)
    log_x = _log_gamma(generator, float(a), shape, device)
    log_y = _log_gamma(generator, float(b), shape, device)
    return torch.sigmoid(log_x - log_y)


class MixUpHook(TrainerHook):
    def __init__(self, name: str = "mix_reg", weight: float = 1.0, alpha: float = 1.0,
                 enable_bn: bool = True):
        super().__init__(name, weight)
        if not float(alpha) > 0:
            raise ValueError(f"MixUpHook alpha must be > 0, got {alpha}")
        self.alpha = float(alpha)
        self.enable_bn = bool(enable_bn)

    def sample(self, generator, ctx):
        img = ctx["labeled_image"]
        n = 2 * img.shape[0] * mesh.world_size()  # the global [view 1; view 2]
        if self.alpha == 1.0:  # Beta(1, 1) = U(0, 1), the draw every config takes
            lam = torch.rand((), generator=generator, device=img.device)
        else:
            lam = sample_beta(generator, self.alpha, self.alpha, (), img.device)
        return {"lam": lam,
                "perm": torch.randperm(n, generator=generator, device=img.device)}

    def loss_fn(self, ctx, scalars):
        views = ("labeled_image", "labeled_image_tf")
        onehots = ("labeled_onehot", "labeled_onehot_tf")
        x = torch.cat([ctx[k] for k in views], dim=0)
        y = torch.cat([ctx[k] for k in onehots], dim=0)
        draw = ctx["draws"][self.name]
        lam, perm = draw["lam"], draw["perm"]
        # the partners of this rank's rows in the global [view 1; view 2]
        n, r = ctx["labeled_image"].shape[0], mesh.world_size()
        own = torch.arange(n, device=perm.device) + mesh.rank() * n
        partner = perm[torch.cat([own, own + r * n])]
        xs = torch.cat([mesh.gather_rows(ctx[k]) for k in views], dim=0)
        ys = torch.cat([mesh.gather_rows(ctx[k]) for k in onehots], dim=0)
        mixed_x = lam * x + (1 - lam) * xs[partner]
        mixed_y = lam * y + (1 - lam) * ys[partner]
        logits = ctx["apply_student"](mixed_x)
        loss = mesh.global_sum(kl_div(torch.softmax(logits, dim=1), mixed_y) / r)
        return loss * self.weight, {"loss": loss.detach()}
