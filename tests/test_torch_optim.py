"""spcl_torch's optimizers (`training/optim.py`) on the CPU.

- The multi-tensor RAdam against the per-parameter loop it replaced (kept
  below as `LoopRAdam`), bit for bit over 10 steps (past the rectification
  threshold at step 6), with and without weight decay, with a frozen
  parameter (no gradient, no update, no state).
- `adam`, `adamw`, `sgd` (momentum 0 and 0.9, nesterov) and `grad_clip`
  against spcl_tpu's `build_optimizer` chains over 5 steps on the same
  gradients. Tolerance: rtol 1e-6, atol 1e-7 on the parameters (O(1), moved
  by O(lr) per step): both sides run the same float32 ops, and optax raises
  b**t and forms the global norm with other float32 roundings than numpy and
  `torch._foreach_norm` do.
- An unknown name raises KeyError, as spcl_tpu's does.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_torch.training import RAdam, build_optimizer

STEPS = 10


class LoopRAdam(torch.optim.Optimizer):
    """RAdam as a Python loop over the parameters, one update each: the
    version before the multi-tensor rewrite, kept as its reference."""

    def __init__(self, params, lr=1e-7, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 threshold=5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, threshold=threshold))

    @torch.no_grad()
    def step(self):
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


def _problem(seed, steps):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(5, 7)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32),
              "frozen": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32) for k, v in params.items()}
             for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("lr", [1e-7, 1e-3])
def test_foreach_radam_equals_the_loop_bit_for_bit(weight_decay, lr):
    params, grads = _problem(1, STEPS)
    sides = []
    for cls in (RAdam, LoopRAdam):
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
        tp["frozen"].requires_grad_(False)
        opt = cls(list(tp.values()), lr=lr, weight_decay=weight_decay)
        trace = []
        for g in grads:
            for k in ("w", "b"):
                tp[k].grad = torch.from_numpy(g[k])
            opt.step()
            trace.append({k: v.detach().clone() for k, v in tp.items()})
        sides.append((trace, opt, tp))
    (new, opt, tp), (old, opt_old, tp_old) = sides
    for step, (a, b) in enumerate(zip(new, old)):
        for k in params:
            assert torch.equal(a[k], b[k]), (step, k)
    assert torch.equal(tp["frozen"], torch.from_numpy(params["frozen"]))
    assert tp["frozen"] not in opt.state
    for k in ("w", "b"):
        for s in ("mu", "nu"):
            assert torch.equal(opt.state[tp[k]][s], opt_old.state[tp_old[k]][s])
        assert opt.state[tp[k]]["step"] == STEPS


CHAINS = [
    dict(name="adam"),
    dict(name="adam", weight_decay=1e-2),
    dict(name="adamw", weight_decay=1e-2),
    dict(name="sgd", momentum=0.0),
    dict(name="sgd", momentum=0.9),
    dict(name="sgd", momentum=0.9, nesterov=True),
    dict(name="sgd", momentum=0.9, weight_decay=1e-2, grad_clip=0.02),  # clips every step
    dict(name="RAdam", weight_decay=1e-5, grad_clip=0.02),
    dict(name="adam", grad_clip=10.0),  # never reaches the norm: no clip
]


@pytest.mark.parametrize("chain", CHAINS, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_chains_match_spcl_tpu(chain):
    lr = 1e-2
    params, grads = _problem(2, 5)
    del params["frozen"]
    tx = jax_build_optimizer(lr=lr, **chain)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = build_optimizer(list(tp.values()), lr=lr, **chain)
    norms = []
    for g in grads:
        norms.append(np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values())))
        updates, state = tx.update({k: jnp.asarray(g[k]) for k in params}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    clip = chain.get("grad_clip")
    if clip:  # the cases clip on every step or on none
        assert all(n > clip for n in norms) or all(n < clip for n in norms)


def test_unknown_optimizer_raises_key_error():
    with pytest.raises(KeyError, match="unknown optimizer 'lamb'"):
        build_optimizer([torch.nn.Parameter(torch.zeros(2))], name="lamb")
    with pytest.raises(KeyError):
        jax_build_optimizer(name="lamb")
