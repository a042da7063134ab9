"""Self-paced SupCon over the global batch of a multi-rank run.

The counterpart of `spcl_tpu/parallel/contrastive.py`. Per-rank inputs are
[n_local, D] views and [n_local] labels / valid flags; every function returns
(loss, downgrade_ratio), identical on every rank and equal to the
single-process loss on the gathered batch (tests/test_torch_parallel_supcon.py).

- `global_self_paced_supcon`: the embeddings are gathered and every rank
  computes the full [2N, 2N] loss (replicated compute; exact, no per-rank
  saving).
- `sharded_self_paced_supcon`: each rank computes only its row strip
  [2 n_local, 2N]; the row reductions combine in one sum over ranks of four
  scalars. The decomposition is exact: the loss is a mean over rows whose
  terms need only full-row sums, and the reference's detached global
  max-subtraction equals 1/T for L2-normalized inputs because every row block
  holds its own diagonal.

`use_fused` "auto" or true sends the loss (the strip) through
`ops.supcon_cuda`: the hand-written kernels on a CUDA tensor at every size,
their plain per-row version on a CPU tensor; false runs the dense loss (the
naive strip in plain tensor code). The JAX package's size thresholds for this
choice were measured on its hardware and are not carried over.

Every returned loss follows the gradient convention of `parallel/mesh.py`:
the ranks' parameter gradients sum to the gradient of the global loss.
"""
from __future__ import annotations

import torch

from . import mesh
from ..losses.supcon import self_paced_supcon_loss
from ..ops.supcon_cuda import fused_self_paced_supcon, sharded_fused_self_paced_supcon


def _fused(use_fused) -> bool:
    return use_fused == "auto" or bool(use_fused)


def global_self_paced_supcon(z1, z2, target, valid, *, gamma: float,
                             temperature: float = 0.07, weight_update: str = "soft",
                             correct_grad: bool = False, use_fused="auto", group=None):
    """Replicated form: gather, then the single-device loss on every rank."""
    zg1 = mesh.all_gather_cat(z1, group)
    zg2 = mesh.all_gather_cat(z2, group)
    tg = mesh.all_gather_cat(target, group)
    vg = mesh.all_gather_cat(valid.float(), group)
    if _fused(use_fused):
        loss, ratio = fused_self_paced_supcon(
            zg1, zg2, gamma=gamma, target=tg, valid=vg, temperature=temperature,
            weight_update=weight_update, correct_grad=correct_grad)
    else:
        loss, aux = self_paced_supcon_loss(
            zg1, zg2, gamma=gamma, target=tg, valid=vg, temperature=temperature,
            weight_update=weight_update, correct_grad=correct_grad)
        ratio = aux.downgrade_ratio
    return mesh.grad_share(loss, group), ratio


def naive_strip_sums(z1, z2, target, valid, zg1, zg2, tg, vg, row_off: int, *,
                     gamma: float, temperature: float, weight_update: str) -> torch.Tensor:
    """The naive strip in plain tensor code: the [2 n_local, 2N] block of
    this rank's rows (z1, z2 [n_local, D], first row at `row_off` of each
    view) against the gathered columns (zg1, zg2 [N, D], tg, vg [N]),
    materialized. Returns the four sums that add up over ranks: row losses,
    valid rows with a positive, self-paced weights, positive pairs. Touches
    no process group."""
    n_local, n_global = z1.shape[0], zg1.shape[0]
    z_rows = torch.cat([z1, z2]).float()
    z_cols = torch.cat([zg1, zg2]).float()
    # reference max-subtraction (contrast_loss3.py:28-29): the detached
    # global max equals the local block's (its diagonal is in every row block)
    sim = (z_rows @ z_cols.T) / temperature
    sim = sim - sim.max().detach()

    t_rows = torch.cat([target, target])
    v_rows = torch.cat([valid, valid]).float()
    t_cols = torch.cat([tg, tg])
    v_cols = torch.cat([vg, vg]).float()
    same = (t_rows[:, None] == t_cols[None, :]).float()
    # local row r is global column row_off + r (view 1) / n_global + row_off + r
    half = torch.arange(n_local, device=z1.device)
    grow = torch.cat([row_off + half, n_global + row_off + half])
    not_diag = 1.0 - (torch.arange(2 * n_global, device=z1.device)[None, :]
                      == grow[:, None]).float()
    pair = v_rows[:, None] * v_cols[None, :] * not_diag
    pos = same * pair
    neg = (1.0 - same) * pair

    denom = (torch.exp(sim) * (pos + neg)).sum(dim=1, keepdim=True)
    log_prob = sim - torch.log(denom + 1e-16)
    l_ij = -log_prob.detach()
    if weight_update == "hard":
        w = (l_ij <= gamma).float()
    else:
        w = torch.clamp(1.0 - l_ij / gamma, min=0.0)
    sp = torch.maximum(w, 1.0 - pos)

    pos_count = pos.sum(dim=1)
    row_loss = (log_prob * sp * pos).sum(dim=1) / torch.clamp(pos_count, min=1.0)
    row_ok = v_rows * (pos_count > 0).float()
    return torch.stack([(row_loss * row_ok).sum(), row_ok.sum(), (sp * pos).sum(), pos.sum()])


def sharded_self_paced_supcon(z1, z2, target, valid, *, gamma: float,
                              temperature: float = 0.07, weight_update: str = "soft",
                              correct_grad: bool = False, use_fused="auto", group=None):
    """Row-sharded form: this rank's strip through the kernels
    (`sharded_fused_self_paced_supcon`), or, with use_fused false, the naive
    strip (`naive_strip_sums`), whose gradient flows back through the
    differentiable gather and sum."""
    if _fused(use_fused):
        return sharded_fused_self_paced_supcon(
            z1, z2, target, valid, gamma=gamma, temperature=temperature,
            weight_update=weight_update, correct_grad=correct_grad, group=group)
    if weight_update not in ("hard", "soft"):
        raise ValueError(weight_update)
    sums = naive_strip_sums(
        z1, z2, target, valid, mesh.all_gather_cat(z1, group), mesh.all_gather_cat(z2, group),
        mesh.all_gather_cat(target, group), mesh.all_gather_cat(valid.float(), group),
        mesh.rank(group) * z1.shape[0], gamma=gamma, temperature=temperature,
        weight_update=weight_update)
    # one sum over ranks combines every cross-rank reduction
    parts = mesh.all_reduce_sum(sums, group)
    loss = -parts[0] / torch.clamp(parts[1], min=1.0)
    ratio = (parts[2] / torch.clamp(parts[3], min=1.0)).detach()
    if correct_grad:
        loss = torch.where(ratio > 0, loss / torch.clamp(ratio, min=1e-16), loss)
    return mesh.grad_share(loss, group), ratio
