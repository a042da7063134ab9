"""Gradient-cache chunked contrastive pretraining: encoder activation memory
O(chunk) instead of O(2N).

The counterpart of `spcl_tpu/training/gradcache.py` (`Trainer.grad_cache:
num_chunks`; Gao et al. 2021, "Scaling Deep Contrastive Learning Batch Size
under Memory Limited Setup", arXiv 2101.06983). The step splits the batch
(a rank's rows under a mesh) into `num_chunks` equal chunks and runs

  pass A (no grads):  z_c = project(encode(augment(x_c))) per chunk, train
                      mode -> embeddings z [2N, D]; a chunk's activations
                      are freed before the next chunk runs
  loss:               (loss, dL/dz) on leaf z tensors — the hooks'
                      criteria (the fused supcon kernels on the card)
  pass B (grads):     re-encode each chunk with autograd and pull the cached
                      dL/dz_c back through it (`torch.autograd.backward`),
                      accumulating the parameter gradients over chunks

at one chunk's activations plus [2N, D] embeddings, for one extra forward.

BatchNorm: each chunk normalises with its own batch statistics, and the
running statistics chain from chunk to chunk in pass A (the convention of
gradient accumulation). Pass B leaves the model's buffers as pass A left
them (spcl_tpu's pass B runs with update_stats=False). The monolithic step
normalises over the whole batch instead, so the two steps are equal in
distribution, not bit-equal; everything downstream of the embeddings is the
same function.

Randomness: the step draws the augmentation and flip parameters of the
whole batch once from the generator (`sample_twice`, `flip_params`, as
`steps.build_pretrain_step` does) and slices them per chunk, so both passes
replay the same geometry; `params` may be injected instead (spcl_tpu folds a
key per chunk, and a test concatenates those draws).

Under a mesh (`parallel/mesh.py`) every rank chunks its own rows, with
rank-local BatchNorm statistics (`models/norm.py::rank_local_statistics`: the
spcl_tpu step runs its UNet without an axis name). The criterion spans the
ranks through the hooks' `_mesh_criterion` (`row_sharded`: the strip
kernels), whose losses follow the port's gradient convention, so the
parameter gradients are SUMMED over ranks (spcl_tpu's pmean cancels an
artefact of its own autodiff and has no counterpart here). The running
statistics are averaged over ranks at the end of the step, as spcl_tpu's
`pmean` does.

Spans (`utils/profiling.py::span`, open only while the torch profiler
runs), inside the step's `spcl.step`: `spcl.step.input` (the draws and the
store's gather), `spcl.gradcache.pass_a` around pass A, then
`spcl.step.loss` and `spcl.step.backward` (dL/dz), and in pass B each
chunk's `spcl.step.input`, `spcl.step.forward` and `spcl.step.backward`;
`spcl.step.optimizer` ends the step. Pass A holds each chunk's
`spcl.step.input` and `spcl.step.forward` (the projection heads included)
too, so the forward's spans cover both passes.

The step carries two test oracles, as spcl_tpu's does:
`direct_value_and_grad` (ordinary autograd through pass A and the loss,
every chunk's activations kept) and `cached_value_and_grad` (the two
passes). Both leave the model as they found it and return {"loss", "hooks",
"grads" (aligned with the optimizer's parameters), "buffers" (the model's
buffers after the step's BatchNorm chain)}.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .steps import _as_float_image, _reduce_gradients, _resolve_batch, _rows, \
    _spanned_step, draw_pretrain_params
from ..data.augment import AugmentPolicy, apply_flip, augment_twice
from ..data.device_store import DeviceStore
from ..hooks.base import TrainerHook, label_from_contrast_on
from ..models.norm import rank_local_statistics
from ..models.stages import is_encoder_stage
from ..models.unet import UNet
from ..parallel import mesh
from ..utils.profiling import span


def _check_hooks(hooks: Sequence[TrainerHook]) -> None:
    for h in hooks:
        # the two passes need the InfoNCE interface: the embedding apart from
        # the criterion, not just a hook on an encoder stage
        if not (hasattr(h, "_projected_views") and hasattr(h, "_criterion")):
            raise NotImplementedError(
                f"grad_cache supports INFONCE-family contrastive hooks (separate embed and "
                f"criterion phases); got {type(h).__name__} ({h.name}) — run it under the "
                "monolithic pretrain step")
        if not is_encoder_stage(h.feature_name):
            # as spcl_tpu refuses it (training/gradcache.py:75-79)
            raise NotImplementedError(
                f"grad_cache supports encoder contrastive hooks; {h.name} taps decoder stage "
                f"{h.feature_name} (dense point sampling is batch-local and does not benefit "
                "from a global batch)")


def _cut(tree, n: int, lo: int, hi: int):
    """Rows [lo, hi) of every tensor in `tree` whose axis 0 has n entries."""
    if isinstance(tree, dict):
        return {k: _cut(v, n, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cut(v, n, lo, hi) for v in tree)
    if torch.is_tensor(tree) and tree.dim() >= 1 and tree.shape[0] == n:
        return tree[lo:hi]
    return tree


def _buffers(model: UNet) -> List[torch.Tensor]:
    return [b.detach().clone() for b in model.buffers()]


def _restore(model: UNet, saved: List[torch.Tensor]) -> None:
    with torch.no_grad():
        for b, s in zip(model.buffers(), saved):
            b.copy_(s)


def _average_running_statistics(model: UNet) -> None:
    """The BatchNorm running statistics averaged over ranks (one collective)."""
    if not mesh.active():
        return
    stats = [t for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)
             and m.running_mean is not None for t in (m.running_mean, m.running_var)]
    flat = mesh.all_reduce_sum(torch.cat([t.reshape(-1) for t in stats])) / mesh.world_size()
    offset = 0
    with torch.no_grad():
        for t in stats:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def build_gradcache_pretrain_step(model: UNet, hooks: Sequence[TrainerHook],
                                  optimizer: torch.optim.Optimizer, *, policy: AugmentPolicy,
                                  total_freedom: bool, until: Optional[str], num_chunks: int,
                                  flip_threshold: float = 0.8,
                                  store: Optional[DeviceStore] = None) -> Callable:
    """Drop-in replacement for `steps.build_pretrain_step` with chunked
    two-pass gradients: step(batch, generator, hook_scalars, params=None) ->
    {"reg_loss", "hooks"}. The (rank's) batch must split into `num_chunks`
    equal chunks."""
    hooks = tuple(hooks)
    num_chunks = int(num_chunks)
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    _check_hooks(hooks)
    params_list = [p for g in optimizer.param_groups for p in g["params"]]

    def prepare(batch, generator, params):
        """This rank's rows of the batch and of the draws, checked to chunk."""
        n_global = _rows(batch)
        if params is None:
            params = draw_pretrain_params(generator, batch, store, policy=policy,
                                          total_freedom=total_freedom,
                                          flip_threshold=flip_threshold)
        batch, params = mesh.shard_rows((batch, params), n_global)
        batch = _resolve_batch(store, batch)
        n = batch["image"].shape[0]
        if n % num_chunks:
            raise ValueError(f"grad_cache: {'per-rank ' if mesh.active() else ''}batch size "
                             f"{n} not divisible by num_chunks={num_chunks}")
        return batch, params, n

    def encode(batch, params, n, c):
        """Chunk c: two views, view 2 flipped, partial forward, each hook's
        (z1_c, z2_c). Deterministic in (batch, params, c)."""
        m = n // num_chunks
        with span("spcl.step.input"):
            bc, pc = _cut((batch, params), n, c * m, (c + 1) * m)
            (v1, _), (v2, _) = augment_twice(_as_float_image(bc["image"]), None, policy,
                                             pc["aug"])
            v2 = apply_flip(v2, pc["flip"])
        with span("spcl.step.forward"):
            acts = model(torch.cat([v1, v2], dim=0), until=until)
            ctx = {"acts": acts, "n_unl": m, "flip": pc["flip"]}
            return {h.name: h._projected_views(ctx) for h in hooks}

    def embed(batch, params, n):
        """Every chunk in turn: the hooks' (z1, z2) over the rank's rows."""
        chunks = [encode(batch, params, n, c) for c in range(num_chunks)]
        with span("spcl.step.forward"):
            return {h.name: tuple(torch.cat([z[h.name][i] for z in chunks], dim=0)
                                  for i in (0, 1)) for h in hooks}

    def loss_on_z(zs, batch, hook_scalars):
        """Everything downstream of the embeddings: the monolithic step's
        hook losses (hooks/infonce.py loss_fn)."""
        total = torch.zeros((), dtype=torch.float32, device=batch["image"].device)
        metrics = {}
        for h in hooks:
            z1, z2 = zs[h.name]
            loss, m = h._criterion(z1, z2, label_from_contrast_on(batch, h.contrast_on),
                                   batch["valid"], hook_scalars.get(h.name, {}))
            total = total + h.weight * loss
            metrics[h.name] = {k: v.detach() if torch.is_tensor(v) else v for k, v in m.items()}
        return total, metrics

    def close(loss, metrics, update=False):
        """Gradients summed and running statistics averaged over ranks; with
        `update`, the optimizer's step."""
        with span("spcl.step.optimizer"):
            _reduce_gradients(optimizer)
            _average_running_statistics(model)
            if update:
                optimizer.step()
        return {"reg_loss": loss.detach(), "hooks": metrics}

    def two_passes(batch, generator, hook_scalars, params=None):
        """Pass A, the loss on the cached embeddings and pass B: (loss,
        metrics), the gradients in the parameters. `close` and the
        optimizer's step run after this frame has returned: the passes'
        tensors are freed before them."""
        with span("spcl.step.input"):
            batch, params, n = prepare(batch, generator, params)
        model.train()
        with rank_local_statistics(model):
            with torch.no_grad(), span("spcl.gradcache.pass_a"):
                zs = embed(batch, params, n)
                after_pass_a = _buffers(model)
            with span("spcl.step.loss"):
                leaves = {k: tuple(z.detach().requires_grad_(True) for z in pair)
                          for k, pair in zs.items()}
                loss, metrics = loss_on_z(leaves, batch, hook_scalars)
            with span("spcl.step.backward"):
                flat = [z for pair in leaves.values() for z in pair]
                dz = torch.autograd.grad(loss, flat, allow_unused=True)
                dz = [torch.zeros_like(z) if d is None else d for z, d in zip(flat, dz)]
                optimizer.zero_grad(set_to_none=True)
            m = n // num_chunks
            for c in range(num_chunks):
                zc = encode(batch, params, n, c)
                with span("spcl.step.backward"):
                    outs = [z for h in hooks for z in zc[h.name]]
                    torch.autograd.backward(outs, [d[c * m:(c + 1) * m] for d in dz])
            _restore(model, after_pass_a)
        return loss, metrics

    def cached(batch, generator, hook_scalars, params=None):
        return close(*two_passes(batch, generator, hook_scalars, params))

    def direct(batch, generator, hook_scalars, params=None):
        batch, params, n = prepare(batch, generator, params)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with rank_local_statistics(model):
            loss, metrics = loss_on_z(embed(batch, params, n), batch, hook_scalars)
            loss.backward()
        return close(loss, metrics)

    @_spanned_step
    def step(batch, generator: Optional[torch.Generator],
             hook_scalars: Dict[str, Dict[str, float]], params: Optional[Dict] = None):
        return close(*two_passes(batch, generator, hook_scalars, params), update=True)

    def oracle(fn):
        def value_and_grad(batch, generator, hook_scalars, params=None):
            before = _buffers(model)
            out = fn(batch, generator, hook_scalars, params)
            result = {"loss": out["reg_loss"], "hooks": out["hooks"],
                      "grads": [None if p.grad is None else p.grad.detach().clone()
                                for p in params_list],
                      "buffers": _buffers(model)}
            _restore(model, before)
            optimizer.zero_grad(set_to_none=True)
            return result
        return value_and_grad

    step.direct_value_and_grad = oracle(direct)
    step.cached_value_and_grad = oracle(cached)
    step.num_chunks = num_chunks
    return step
