"""The training and eval steps: contrastive pretrain, fine-tune, semi, eval.

The semantics of `spcl_tpu/training/steps.py`:

- `build_pretrain_step` (reference _PretrainEpocherMixin,
  new_pretrain.py:19-126): two augmented views made on the device, view 2
  additionally flipped with replayable params, one partial forward of both
  views to `until` (train-mode BN), loss = sum of the hooks' losses, one
  optimizer step;
- `build_finetune_step` (reference FineTuneEpocher, new_epocher.py:241-289):
  one augmented labeled view, whole UNet in train mode, pixel-mean
  cross-entropy over valid slices, one optimizer step, per-slice Dice
  statistics of the prediction; with hooks (the MixUp trainer, reference
  MixUpEpocher, new_comparable.py:18-86) two labeled views and the hooks'
  losses added;
- `build_semi_step` (reference SemiSupervisedEpocher._run_semi,
  new_epocher.py:145-238; spcl_tpu steps.py:233-368): the cross-entropy of
  the labeled view plus the hooks' regularisers on the unlabeled pair, one
  forward of [labeled, unlabeled, unlabeled_tf] (or, with `two_stage`, the
  labeled batch first and the unlabeled pair second, its BatchNorm
  statistics frozen with `disable_bn`), one backward, one optimizer step,
  then the EMA teacher's update when a hook needs the teacher;
- `build_adversarial_step` (reference AdversarialEpocher,
  new_comparable.py:89-206; spcl_tpu steps.py:502-579): the segmentor as the
  generator (cross-entropy of the labeled view plus `reg_weight` x the BCE
  of the discriminator's verdict on the unlabeled softmax against "real"),
  then one discriminator step (labeled softmax real, unlabeled fake);
- `build_eval_step` (reference EvalEpocher, new_epocher.py:56-97): val
  transform, eval-mode forward, masked cross-entropy and Dice statistics.

Every step takes a host-made batch dict (`batch_to_device`, or
`data/loader.py::device_prefetch`) or, when it was built with a
`DeviceStore` (`Trainer.device_data`), a [B] index tensor on the device whose
batch is gathered from the store there (spcl_tpu steps.py:45-52
`_resolve_batch`); images stay uint8 until `_as_float_image`.

Randomness comes from the step's `torch.Generator`. A caller may instead
inject the drawn values — `params={"aug": <sample_twice dict>, "flip":
<flip_params dict>}` for the pretrain step, `params={"aug": <sample_once
dict>}` for the fine-tune step (<sample_twice dict> with hooks), and
`params={"lab": ..., "unl": ..., "flip": ...}` (`draw_semi_params`) for the
semi step and `params={"lab": <sample_once dict>, "unl": <sample_once
dict>}` (`draw_adversarial_params`) for the adversarial step, each
optionally with `"hooks": {name: draws}` for the hooks that draw
(`TrainerHook.sample`) — so a test can replay the JAX step's draws exactly.

Spans (`utils/profiling.py::span`, open only while the torch profiler
runs): every train step's call is `spcl.step`, and the pretrain, fine-tune
and semi steps split it into `spcl.step.input` (the draws, the store's
gather, augmentation and flips), `spcl.step.forward` (the student's
forward of the views' concatenation), `spcl.step.teacher` (the EMA
teacher's prediction), `spcl.step.loss` (the hooks' losses, the
cross-entropy; after the update, the Dice statistics and the global
outputs, so that their temporaries never sit on top of the activations),
`spcl.step.backward` (`zero_grad`, which does no device work, and the
backward), `spcl.step.optimizer` (the gradients summed over ranks, the
optimizer's step) and `spcl.step.ema` (the teacher's update). The
adversarial step has `spcl.step` alone.

Auxiliary forwards (the EMA teacher, the mixup forward, UC-MT's noisy
teacher passes, the `disable_bn` second pass) run in train mode with the
BatchNorm statistics frozen (`models/norm.py::frozen_statistics`), as
spcl_tpu's `update_stats=False` does; on the fused stages too.

In a multi-rank run (`parallel/mesh.py`) every step keeps global-batch
semantics, as `spcl_tpu/training/steps.py:12` states them: every rank is
handed the same GLOBAL batch (or index vector) and makes (or is handed) the
same global draws, computes on its own rows of both (`shard_rows`; an index
vector is cut before its rows are gathered; the hooks' draws stay global and
each hook keeps its rows, `hooks/base.py`), writes its loss so that the
ranks' gradients sum to the global gradient (a mean over the global count;
`grad_share` inside the losses that are not separable over the batch), and
sums the parameter gradients over ranks before the optimizer step (the
hooks' projectors and the discriminator's included). BatchNorm statistics
span the ranks (`models/norm.py`), the EMA teacher's and the auxiliary
forwards' too. Every rank calls the collectives in the same order: the same
forwards, hooks and discriminator passes in the same order on every rank.
Losses and hook metrics come back as global values, per-slice Dice
statistics gathered in global row order, identical on every rank. In one
process all of this is the identity.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.utils._pytree as pytree

import torch.nn.functional as F
from torch import nn

from ..data.augment import (AugmentPolicy, apply_flip, apply_geometric, augment_once,
                            augment_twice, center_geometric, flip_params, frame_pixel_mask,
                            sample_once, sample_twice)
from ..data.device_store import DeviceStore
from ..hooks.base import TrainerHook
from ..hooks.mixup import MixUpHook
from ..losses.functional import class2one_hot
from ..meters.dice import dice_stats_from_labels
from ..models.ema import EMATeacher
from ..models.norm import frozen_statistics
from ..models.unet import UNet
from ..parallel import mesh
from ..utils.profiling import GRAPH_COUNTS, LAUNCH_COUNTERS, span

_META_KEYS = ("partition", "patient", "cycle", "scan_idx", "valid")


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Host batch dict (numpy) -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _global_view(store: Optional[DeviceStore], batch):
    """(rows, canvas size, stored slice extents [B, 2], device) of a global
    batch dict or index vector: what the step's random draws depend on."""
    if isinstance(batch, dict):
        image = batch["image"]
        return image.shape[0], image.shape[-1], batch.get("size"), image.device
    if store is None:
        raise ValueError("an index batch needs the step's DeviceStore (store=...)")
    return (batch.shape[0], store.arrays["image"].shape[-1], store.sizes_of(batch),
            batch.device)


def _rows(batch) -> int:
    return (batch["image"] if isinstance(batch, dict) else batch).shape[0]


def _resolve_batch(store: Optional[DeviceStore], batch) -> Dict[str, torch.Tensor]:
    """The batch dict of a host-made batch (unchanged) or of an index vector
    (gathered from `store` on the device)."""
    return batch if isinstance(batch, dict) else store.gather(batch)


def draw_pretrain_params(generator: torch.Generator, batch, store: Optional[DeviceStore], *,
                         policy: AugmentPolicy, total_freedom: bool,
                         flip_threshold: float = 0.8,
                         hooks: Optional[Sequence[TrainerHook]] = None,
                         params: Optional[Dict] = None) -> Dict:
    """The pretrain step's draws for a global batch: {"aug": <sample_twice
    dict>, "flip": <flip_params dict>}, unless `params` (draws a caller
    injected) holds them; with `hooks`, also {"hooks": {name: draws}} of the
    hooks that draw (`TrainerHook.sample`, in hook order, after the views'
    draws), unless `params` holds "hooks"."""
    if params is None:
        n, in_size, sizes, device = _global_view(store, batch)
        params = {"aug": sample_twice(generator, n, policy, in_size,
                                      total_freedom=total_freedom, sizes=sizes, device=device),
                  "flip": flip_params(generator, n, threshold=flip_threshold, device=device)}
    if hooks is None or "hooks" in params:
        return params
    n = _rows(batch)
    valid = batch["valid"] if isinstance(batch, dict) else (batch >= 0).to(torch.float32)
    ctx = {"n_unl": n, "valid": valid, "n_global": n, "row_offset": 0}
    draws = {h.name: h.sample(generator, ctx) for h in hooks}
    return {**params, "hooks": {k: v for k, v in draws.items() if v is not None}}


def _as_float_image(img: torch.Tensor) -> torch.Tensor:
    """Batches ship images as packed uint8; scale to [0, 1] float32 on the
    device. Float inputs pass through as float32: the augmentation runs in
    float32 and the UNet casts its input to its compute dtype (`Arch.dtype`),
    as spcl_tpu's does (steps.py:55-61, models/unet.py:178). Under bfloat16
    the logits come back from the UNet in float32 (bf16-rounded values), so
    the cross-entropy's log_softmax is float32 as spcl_tpu's is; the heads
    pool features as float32 and the contrastive losses see float32 z."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img.float()


def build_pretrain_step(model: UNet, hooks: Sequence[TrainerHook],
                        optimizer: torch.optim.Optimizer, *, policy: AugmentPolicy,
                        total_freedom: bool, until: Optional[str],
                        flip_threshold: float = 0.8,
                        store: Optional[DeviceStore] = None) -> Callable:
    """Returns step(batch, generator, hook_scalars, params=None) -> metrics.

    `batch` holds device tensors (`batch_to_device`), or is an index vector
    into `store`; metrics are detached device tensors — {"reg_loss": ...,
    "hooks": {name: {...}}} — so the caller decides when to synchronise.

    Every draw of the step, the hooks' included, is made first
    (`draw_pretrain_params`). On a card in a single process the step is
    replayed as a CUDA graph (`GraphedStep`): the draws are made eagerly,
    the rest of the step (gather, augmentation, forward, loss, backward,
    optimizer) replays."""
    hooks = tuple(hooks)

    def draw(batch, generator: Optional[torch.Generator],
             params: Optional[Dict] = None) -> Dict:
        return draw_pretrain_params(generator, batch, store, policy=policy,
                                    total_freedom=total_freedom,
                                    flip_threshold=flip_threshold, hooks=hooks, params=params)

    def step(batch, generator: Optional[torch.Generator],
             hook_scalars: Dict[str, Dict[str, float]], params: Optional[Dict] = None):
        n_global = _rows(batch)
        with span("spcl.step.input"):
            params = draw(batch, generator, params)
            batch, params = _shard_step_rows(batch, params, n_global)
            batch = _resolve_batch(store, batch)
            image = _as_float_image(batch["image"])
            n = image.shape[0]
            (v1, _), (v2, _) = augment_twice(image, None, policy, params["aug"])
            fp = params["flip"]
            v2 = apply_flip(v2, fp)
        with span("spcl.step.forward"):
            model.train()
            acts = model(torch.cat([v1, v2], dim=0), until=until)
        with span("spcl.step.loss"):
            ctx = {"acts": acts, "n_unl": n, "flip": fp, **_global_rows(n)}
            ctx.update({k: batch[k] for k in _META_KEYS})
            total, hook_metrics = _hook_losses(hooks, ctx, None, params, hook_scalars,
                                               image.device)
        _backward(optimizer, total)
        _optimizer_step(optimizer)
        return {"reg_loss": total.detach(), "hooks": hook_metrics}

    return GraphedStep(step, draw, optimizer)


def build_matrix_probe(model: UNet, hooks: Sequence[TrainerHook], *, policy: AugmentPolicy,
                       total_freedom: bool, until: Optional[str],
                       flip_threshold: float = 0.8,
                       store: Optional[DeviceStore] = None) -> Optional[Callable]:
    """Once-an-epoch diagnostics (`Trainer.dump_matrices`; spcl_tpu
    steps.py:459-499): batch 0's contrastive matrices (similarity logits, their
    exp, the positive mask, and the self-paced mask) for every hook with a
    `matrices_fn`, kept out of the step so that the [2N, 2N] tensors exist
    only here. Returns probe(batch, generator, hook_scalars, params=None) ->
    {hook: {name: tensor}}, or None when no hook makes matrices.

    The probe makes the pretrain step's draws for `batch` from `generator`
    (the trainer hands it a copy of its generator, so that they are the
    draws of the epoch's first step and the step's own stay untouched) and
    runs the UNet in eval mode, with its running statistics, as spcl_tpu's
    does; the matrices come from the plain dense losses."""
    drawing = tuple(hooks)  # every hook draws, in the step's order
    hooks = tuple(h for h in drawing if hasattr(h, "matrices_fn"))
    if not hooks:
        return None

    @torch.no_grad()
    def probe(batch, generator: Optional[torch.Generator],
              hook_scalars: Dict[str, Dict[str, float]], params: Optional[Dict] = None):
        params = draw_pretrain_params(generator, batch, store, policy=policy,
                                      total_freedom=total_freedom,
                                      flip_threshold=flip_threshold, hooks=drawing,
                                      params=params)
        batch = _resolve_batch(store, batch)
        image = _as_float_image(batch["image"])
        (v1, _), (v2, _) = augment_twice(image, None, policy, params["aug"])
        fp = params["flip"]
        was_training = model.training
        model.eval()
        try:
            acts = model(torch.cat([v1, apply_flip(v2, fp)], dim=0), until=until)
        finally:
            model.train(was_training)
        ctx = {"acts": acts, "n_unl": image.shape[0], "flip": fp}
        ctx.update({k: batch[k] for k in _META_KEYS})
        ctx["draws"] = {h.name: params["hooks"].get(h.name) for h in drawing}
        return {h.name: h.matrices_fn(ctx, hook_scalars.get(h.name, {})) for h in hooks}

    return probe


def _by_path(tree) -> Dict[str, object]:
    """{key path: leaf} of a tree of dicts, lists and tuples."""
    return {pytree.keystr(path): leaf for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def _layout(tree) -> tuple:
    """What a capture is specific to in `tree`: each leaf's key path with,
    for a tensor, its shape, dtype and device, else its value; in path
    order, so that the order of a dict's keys does not matter."""
    return tuple(sorted((k, (tuple(v.shape), v.dtype, v.device) if torch.is_tensor(v) else v)
                        for k, v in _by_path(tree).items()))


def _state_tensors(optimizer: torch.optim.Optimizer) -> Dict[int, tuple]:
    """{id(parameter): ids of its state's tensors} of the parameters that
    have optimizer state."""
    return {id(p): tuple(id(v) for v in s.values() if torch.is_tensor(v))
            for p, s in optimizer.state.items() if s}


class GraphedStep:
    """A train step replayed as one CUDA graph in a single process on a card.

    `eager(batch, generator, hook_scalars, params)` is the eager step and
    `draw(batch, generator, params)` completes `params` with every random
    draw the step takes (augmentation, flips, the hooks' `sample`), as the
    eager step does first. Where the step engages (a CUDA batch, no process
    group: `mesh.active()` false), a call draws eagerly, copies the batch and
    the draws into static buffers and replays:

    - the first call at a new layout (shapes and dtypes of the batch and the
      draws, the backends' precision settings) is an ordinary eager step on
      the capture stream, which warms up what a capture cannot (kernel
      builds, cuDNN's plans, the optimizer's state);
    - the next call captures the step on those buffers (gather,
      augmentation, forward, loss, backward, optimizer) and replays it once;
      later calls replay;
    - the host values a capture freezes (each group's learning rate and
      settings, the hooks' scalars such as gamma, the optimizer's `step`
      method) are read at every call, and a change (an epoch boundary)
      captures anew into the same memory pool, before the old graph is
      released, so that reserved memory does not grow with the epochs;
    - a capture that made optimizer state (a parameter that took no step
      before it, whose moments the graph would zero at every replay) is
      thrown away with that state: the call runs eagerly and the next one
      captures. One that replaced existing state raises.

    The optimizer must take no host value that changes from step to step
    (`training/optim.py` keeps its step counts on the device). A call returns
    fresh metric tensors: one copy of the graph's outputs a step. Elsewhere
    (the CPU, a process group) a call is the eager step. `GRAPH_COUNTS` in
    `utils/profiling.py` counts captures and replays; a replay adds the
    kernel launches its capture counted to every registered `LAUNCHES`
    (`utils/profiling.py::LAUNCH_COUNTERS`), so that they count every
    launch, replayed or not."""

    def __init__(self, step: Callable, draw: Callable, optimizer: torch.optim.Optimizer):
        self.eager, self.draw, self._optimizer = step, draw, optimizer
        self._warm = None        # the layout warmed up last
        self._key = None         # what the graph was captured with
        self._graph = self._pool = self._stream = None
        self._static = None      # {key path: static input tensor}
        self._out = None         # (outputs' tree spec, leaves, their tensors in one buffer)
        self._launches = []

    def engages(self, batch) -> bool:
        device = (batch["image"] if isinstance(batch, dict) else batch).device
        return device.type == "cuda" and not mesh.active() and torch.is_grad_enabled()

    def _host_values(self, hook_scalars) -> tuple:
        groups = tuple(tuple(sorted((k, repr(v)) for k, v in g.items() if k != "params"))
                       for g in self._optimizer.param_groups)
        step = getattr(self._optimizer.step, "__func__", self._optimizer.step)
        return groups, _layout(hook_scalars), step

    def __call__(self, batch, generator: Optional[torch.Generator],
                 hook_scalars: Dict[str, Dict[str, float]], params: Optional[Dict] = None):
        with span("spcl.step"):
            if not self.engages(batch):
                return self.eager(batch, generator, hook_scalars, params)
            return self._graphed(batch, generator, hook_scalars, params)

    def _graphed(self, batch, generator, hook_scalars, params):
        with span("spcl.step.input"):
            inputs = (batch, self.draw(batch, generator, params))
            b = torch.backends
            layout = (_layout(inputs), b.cudnn.allow_tf32, b.cudnn.deterministic,
                      b.cudnn.benchmark, b.cuda.matmul.allow_tf32)
            key = (layout, self._host_values(hook_scalars))
        if self._stream is None:
            device = (batch["image"] if isinstance(batch, dict) else batch).device
            self._stream = torch.cuda.Stream(device=device)
            self._pool = torch.cuda.graph_pool_handle()
        if layout != self._warm:
            self._release()
            self._warm = layout
            return self._eager_on_stream(inputs, hook_scalars)
        if key != self._key:
            if not self._capture(inputs, hook_scalars, key):
                return self._eager_on_stream(inputs, hook_scalars)
        else:
            with span("spcl.step.input"):
                flat = _by_path(inputs)
                torch._foreach_copy_(list(self._static.values()), [flat[k] for k in self._static])
        self._graph.replay()
        GRAPH_COUNTS["replays"] += 1
        for counts, name, n in self._launches:
            counts[name] += n
        spec, leaves, buffer = self._out
        pieces = iter(buffer.clone().split([t.numel() for t in leaves if torch.is_tensor(t)]))
        return pytree.tree_unflatten([next(pieces).view(t.shape).to(t.dtype)
                                      if torch.is_tensor(t) else t for t in leaves], spec)

    def _on_stream(self, fn):
        """fn() on the capture stream, ordered after and before the current."""
        current = torch.cuda.current_stream()
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = fn()
        current.wait_stream(self._stream)
        return out

    def _eager_on_stream(self, inputs, hook_scalars):
        out = self._on_stream(lambda: self.eager(inputs[0], None, hook_scalars, inputs[1]))
        for t in pytree.tree_leaves(out):
            if torch.is_tensor(t):
                t.record_stream(torch.cuda.current_stream())
        return out

    def _capture(self, inputs, hook_scalars, key) -> bool:
        """Capture the step on fresh static copies of `inputs`; the previous
        graph is released only after, so that its pool's blocks serve this
        capture instead of new ones. False where the capture made optimizer
        state: graph and state are dropped, and the caller runs eagerly."""
        old = self._graph
        self._graph = self._key = self._static = self._out = None
        static = pytree.tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, inputs)
        state = _state_tensors(self._optimizer)
        graph = torch.cuda.CUDAGraph()

        def capture():
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                out = self.eager(static[0], None, hook_scalars, static[1])
                leaves, spec = pytree.tree_flatten(out)
                buffer = torch.cat([t.reshape(-1).float() for t in leaves if torch.is_tensor(t)])
            finally:
                graph.capture_end()
            return spec, leaves, buffer

        counted = [dict(c) for c in LAUNCH_COUNTERS]
        out = self._on_stream(capture)
        # a capture launches nothing: its calls count at each replay
        launches = [(c, k, c[k] - b[k]) for c, b in zip(LAUNCH_COUNTERS, counted)
                    for k in c if c[k] != b[k]]
        for counts, name, n in launches:
            counts[name] -= n
        if old is not None:
            old.reset()
        made = _state_tensors(self._optimizer)
        if made != state:
            graph.reset()  # no graph holds the pool now: the next capture takes a new one
            self._pool = torch.cuda.graph_pool_handle()
            if any(made.get(p) != ids for p, ids in state.items()):
                raise RuntimeError("the optimizer replaced its state inside a captured step: "
                                   "the step cannot be replayed as a CUDA graph")
            for p in [p for p in self._optimizer.state if id(p) not in state]:
                del self._optimizer.state[p]
            return False
        self._graph, self._key, self._launches, self._out = graph, key, launches, out
        self._static = {k: v for k, v in _by_path(static).items() if torch.is_tensor(v)}
        GRAPH_COUNTS["captures"] += 1
        return True

    def _release(self) -> None:
        """Drop the graph and start a new pool for the next capture."""
        if self._graph is not None:
            self._graph.reset()
            self._pool = torch.cuda.graph_pool_handle()
        self._graph = self._key = self._static = self._out = None


def _shard_step_rows(batch, params: Dict, n_global: int):
    """This rank's rows of a global batch and of the step's draws; the
    hooks' draws stay global (each hook keeps its own rows)."""
    hook_draws = params.get("hooks")
    batch, params = mesh.shard_rows((batch, {k: v for k, v in params.items() if k != "hooks"}),
                                    n_global)
    if hook_draws is not None:
        params["hooks"] = hook_draws
    return batch, params


def _global_rows(n_local: int) -> Dict[str, int]:
    """The ctx keys of the global batch (`hooks/base.py`): its N and this
    rank's first row; every rank holds the same number of rows."""
    return {"n_global": n_local * mesh.world_size(), "row_offset": n_local * mesh.rank()}


def _reduce_gradients(optimizer: torch.optim.Optimizer) -> None:
    """Sum the parameter gradients over ranks (no-op in one process): the
    optimizer holds the hooks' projectors too (the trainers build them
    before it)."""
    mesh.all_reduce_grads([p for g in optimizer.param_groups for p in g["params"]])


def _spanned_step(step: Callable) -> Callable:
    """`step` with its whole call in the span `spcl.step`."""
    @functools.wraps(step)
    def spanned(*args, **kwargs):
        with span("spcl.step"):
            return step(*args, **kwargs)
    return spanned


def _backward(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """The parameters' gradients of `loss`, in the span `spcl.step.backward`
    (`zero_grad(set_to_none=True)` before it does no device work)."""
    with span("spcl.step.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()


def _optimizer_step(optimizer: torch.optim.Optimizer) -> None:
    """The gradients summed over ranks, then the optimizer's step, in the
    span `spcl.step.optimizer`."""
    with span("spcl.step.optimizer"):
        _reduce_gradients(optimizer)
        optimizer.step()


def _masked_ce(logits: torch.Tensor, onehot: torch.Tensor, valid: torch.Tensor,
               pixel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixel-mean CE over valid slices (kl_div(softmax, onehot) parity) on
    [B, C, h, w] logits. `pixel_mask` [B, h, w] additionally restricts to
    in-frame pixels (the shortest-side val-resize path pads non-square
    frames). In a multi-rank run this is the rank's SHARE of the global mean:
    its rows' sum over the global count of valid pixels (ranks hold different
    numbers of valid rows once a batch is padded), so the shares, and their
    gradients, add up to the global loss."""
    logp = F.log_softmax(logits, dim=1)
    ce = -(onehot * logp).sum(dim=1)  # [B, h, w]
    m = valid[:, None, None] * torch.ones_like(ce)
    if pixel_mask is not None:
        m = m * pixel_mask
    return (ce * m).sum() / torch.clamp(mesh.all_reduce_sum(m.sum()), min=1.0)


def _global_outputs(loss_share: torch.Tensor, inter: torch.Tensor, union: torch.Tensor):
    """(loss, inter, union) of the global batch from a rank's loss share and
    its rows' Dice statistics."""
    stats = mesh.all_gather_cat(torch.stack([inter, union], dim=1))
    return mesh.all_reduce_sum(loss_share.detach()), stats[:, 0], stats[:, 1]


def build_eval_step(model: UNet, *, num_classes: int, crop: int,
                    val_policy: Optional[AugmentPolicy] = None,
                    out_size: Optional[int] = None,
                    store: Optional[DeviceStore] = None) -> Callable:
    """Returns eval_step(batch) -> {"loss", "inter", "union"} (device
    tensors): val transform (center crop, or plain resize for the
    resize-based datasets) -> eval-mode forward -> masked CE + per-slice dice
    statistics. `out_size` > crop: shortest-side val resize on non-square
    slices; the frame pads into the canvas and loss and dice restrict to
    frame pixels. Eval mode takes the UNet's plain path under every
    `small_c_layout` but `packed`, whose Conv1 / Conv2 normalise with their
    running statistics as spcl_tpu's packed stages do."""
    shortest_side = val_policy is not None and isinstance(val_policy.resize, int)
    out = crop if out_size is None else int(out_size)
    pol = val_policy if val_policy is not None else AugmentPolicy(crop=crop)

    @torch.no_grad()
    def eval_step(batch):
        batch = _resolve_batch(store, mesh.shard_rows(batch, _rows(batch)))
        image = _as_float_image(batch["image"])
        geo = center_geometric(image.shape[0], pol, image.shape[-1], batch.get("size"), out,
                               device=image.device)
        img, lab = apply_geometric(image, batch["label"].long(), geo, out)
        pix = frame_pixel_mask(geo, out) if shortest_side else None
        model.eval()
        logits = model(img)["logits"]
        loss = _masked_ce(logits, class2one_hot(lab, num_classes), batch["valid"],
                          pixel_mask=pix)
        inter, union = dice_stats_from_labels(logits.argmax(dim=1), lab, num_classes,
                                              batch["valid"], pixel_mask=pix)
        loss, inter, union = _global_outputs(loss, inter, union)
        return {"loss": loss, "inter": inter, "union": union}

    return eval_step


def _hook_losses(hooks: Sequence[TrainerHook], ctx: Dict, generator, params: Dict,
                 hook_scalars: Dict, device):
    """(sum of the hooks' weighted losses, {name: detached metrics}). Each
    hook's draws are the injected `params["hooks"][name]` or its own
    `sample` from `generator`, made in hook order before any loss."""
    injected = params.get("hooks") or {}
    ctx["draws"] = {h.name: injected[h.name] if h.name in injected
                    else h.sample(generator, ctx) for h in hooks}
    total = torch.zeros((), dtype=torch.float32, device=device)
    metrics = {}
    for h in hooks:
        loss, m = h.loss_fn(ctx, hook_scalars.get(h.name, {}))
        total = total + loss
        metrics[h.name] = {k: v.detach() if torch.is_tensor(v) else v for k, v in m.items()}
    return total, metrics


def _student_fn(model: UNet) -> Callable:
    """apply_student: the student's logits in train mode with its BatchNorm
    statistics frozen; gradients flow."""
    def apply_student(images: torch.Tensor) -> torch.Tensor:
        with frozen_statistics(model):
            return model(images)["logits"]
    return apply_student


def build_finetune_step(model: UNet, optimizer: torch.optim.Optimizer, *, num_classes: int,
                        policy: AugmentPolicy, store: Optional[DeviceStore] = None,
                        hooks: Sequence[TrainerHook] = ()) -> Callable:
    """Returns step(batch, generator, params=None, hook_scalars=None) ->
    {"sup_loss", "inter", "union"} (detached device tensors; "hooks" too
    with hooks): the labeled-only step. With hooks (the mixup trainer) it
    makes two labeled views (spcl_tpu steps.py:163-200) and adds the hooks'
    losses."""
    hooks = tuple(hooks)

    def step(batch, generator: Optional[torch.Generator], params: Optional[Dict] = None,
             hook_scalars: Optional[Dict] = None):
        n_global = _rows(batch)
        with span("spcl.step.input"):
            if params is None:
                _, in_size, sizes, device = _global_view(store, batch)
                draw = (sample_twice(generator, n_global, policy, in_size, total_freedom=True,
                                     sizes=sizes, device=device) if hooks else
                        sample_once(generator, n_global, policy, in_size, sizes=sizes,
                                    device=device))
                params = {"aug": draw}
            batch, params = _shard_step_rows(batch, params, n_global)
            batch = _resolve_batch(store, batch)
            image = _as_float_image(batch["image"])
            label = batch["label"].long()
            if hooks:
                (img, lab), (img2, lab2) = augment_twice(image, label, policy, params["aug"])
            else:
                img, lab = augment_once(image, label, policy, params["aug"])
        with span("spcl.step.forward"):
            model.train()
            acts = model(img)
            logits = acts["logits"]
        with span("spcl.step.loss"):
            onehot = class2one_hot(lab, num_classes)
            sup = _masked_ce(logits, onehot, batch["valid"])
            total = sup
            if hooks:
                ctx = {"acts": acts, "num_classes": num_classes, "valid": batch["valid"],
                       "apply_student": _student_fn(model), "labeled_image": img,
                       "labeled_onehot": onehot, "labeled_image_tf": img2,
                       "labeled_onehot_tf": class2one_hot(lab2, num_classes)}
                reg, hook_metrics = _hook_losses(hooks, ctx, generator, params,
                                                 hook_scalars or {}, image.device)
                total = sup + reg
        _backward(optimizer, total)
        _optimizer_step(optimizer)
        with span("spcl.step.loss"):
            inter, union = dice_stats_from_labels(logits.detach().argmax(dim=1), lab,
                                                  num_classes, batch["valid"])
            sup, inter, union = _global_outputs(sup, inter, union)
        out = {"sup_loss": sup, "inter": inter, "union": union}
        if hooks:
            out["hooks"] = hook_metrics
        return out

    return _spanned_step(step)


def draw_semi_params(generator: torch.Generator, batch_l, batch_u,
                     store: Optional[DeviceStore], *, policy: AugmentPolicy,
                     two_labeled_views: bool = False, flip_threshold: float = 0.8) -> Dict:
    """The semi step's draws (spcl_tpu steps.py:246-261): {"lab": one view's
    draws of the labeled batch (two views' with a mixup hook), "unl": two
    views of the unlabeled batch sharing one geometry, "flip": the flips of
    the unlabeled pair}."""
    n_l, in_l, sizes_l, device = _global_view(store, batch_l)
    n_u, in_u, sizes_u, _ = _global_view(store, batch_u)
    lab = (sample_twice(generator, n_l, policy, in_l, total_freedom=True, sizes=sizes_l,
                        device=device) if two_labeled_views else
           sample_once(generator, n_l, policy, in_l, sizes=sizes_l, device=device))
    return {"lab": lab,
            "unl": sample_twice(generator, n_u, policy, in_u, total_freedom=False,
                                sizes=sizes_u, device=device),
            "flip": flip_params(generator, n_u, threshold=flip_threshold, device=device)}


def build_semi_step(model: UNet, hooks: Sequence[TrainerHook],
                    optimizer: torch.optim.Optimizer, *, num_classes: int,
                    policy: AugmentPolicy, flip_threshold: float = 0.8,
                    two_stage: bool = False, disable_bn: bool = False,
                    teacher: Optional[EMATeacher] = None,
                    store: Optional[DeviceStore] = None) -> Callable:
    """Returns step(batch_l, batch_u, generator, hook_scalars, params=None)
    -> {"sup_loss", "reg_loss", "inter", "union", "hooks"} (detached device
    tensors). `teacher` (required when a hook needs_teacher) predicts the
    plain unlabeled batch before the update and takes its EMA step after
    the optimizer's (the same teacher on every rank of a multi-rank run)."""
    hooks = tuple(hooks)
    needs_teacher = any(h.needs_teacher for h in hooks)
    needs_mixup = any(isinstance(h, MixUpHook) for h in hooks)
    if needs_teacher and teacher is None:
        raise ValueError("a hook needs the EMA teacher: pass teacher=EMATeacher(model)")
    apply_student = _student_fn(model)

    def step(batch_l, batch_u, generator: Optional[torch.Generator],
             hook_scalars: Dict[str, Dict[str, float]], params: Optional[Dict] = None):
        n_l_global, n_u_global = _rows(batch_l), _rows(batch_u)
        with span("spcl.step.input"):
            if params is None:
                params = draw_semi_params(generator, batch_l, batch_u, store, policy=policy,
                                          two_labeled_views=needs_mixup,
                                          flip_threshold=flip_threshold)
            batch_l, lab_draws = mesh.shard_rows((batch_l, params["lab"]), n_l_global)
            batch_u, unl_draws, fp = mesh.shard_rows((batch_u, params["unl"], params["flip"]),
                                                     n_u_global)
            batch_l = _resolve_batch(store, batch_l)
            batch_u = _resolve_batch(store, batch_u)
            image_l = _as_float_image(batch_l["image"])
            label_l = batch_l["label"].long()
            if needs_mixup:
                (img_l, lab_l), (img_l2, lab_l2) = augment_twice(image_l, label_l, policy,
                                                                 lab_draws)
            else:
                img_l, lab_l = augment_once(image_l, label_l, policy, lab_draws)
            (img_u, _), (img_u_cf, _) = augment_twice(_as_float_image(batch_u["image"]), None,
                                                      policy, unl_draws)
            n_l, n_u = img_l.shape[0], img_u.shape[0]
            img_u_tf = apply_flip(img_u_cf, fp)

        with span("spcl.step.forward"):
            model.train()
            if not two_stage:
                acts = model(torch.cat([img_l, img_u, img_u_tf], dim=0))
                logits = acts["logits"]
                logits_l = logits[:n_l]
                logits_u, logits_u_tf = logits[n_l:n_l + n_u], logits[n_l + n_u:]
            else:
                logits_l = model(img_l)["logits"]
                with frozen_statistics(model) if disable_bn else contextlib.nullcontext():
                    acts = model(torch.cat([img_u, img_u_tf], dim=0))
                logits_u, logits_u_tf = acts["logits"][:n_u], acts["logits"][n_u:]

        if needs_teacher:
            with span("spcl.step.teacher"):
                teacher_logits_tf = apply_flip(teacher.logits(img_u), fp)
        with span("spcl.step.loss"):
            onehot_l = class2one_hot(lab_l, num_classes)
            sup = _masked_ce(logits_l, onehot_l, batch_l["valid"])
            ctx = {"acts": acts, "n_unl": n_u, "flip": fp, **_global_rows(n_u),
                   "unlabeled_tf_logits": logits_u_tf,
                   # the same flips replayed on the plain batch's prediction (reference
                   # :169-170)
                   "unlabeled_logits_tf": apply_flip(logits_u, fp),
                   "unlabeled_image": img_u, "unlabeled_image_tf": img_u_tf,
                   "apply_student": apply_student, "num_classes": num_classes,
                   "labeled_image": img_l, "labeled_onehot": onehot_l}
            ctx.update({k: batch_u[k] for k in _META_KEYS})
            if needs_teacher:
                ctx["teacher_logits_tf"] = teacher_logits_tf
                ctx["apply_teacher"] = teacher.logits
            if needs_mixup:
                ctx["labeled_image_tf"] = img_l2
                ctx["labeled_onehot_tf"] = class2one_hot(lab_l2, num_classes)
            reg, hook_metrics = _hook_losses(hooks, ctx, generator, params, hook_scalars,
                                             image_l.device)
            total = sup + reg
        _backward(optimizer, total)
        _optimizer_step(optimizer)
        if needs_teacher:
            with span("spcl.step.ema"):
                teacher.update(model)
        with span("spcl.step.loss"):
            inter, union = dice_stats_from_labels(logits_l.detach().argmax(dim=1), lab_l,
                                                  num_classes, batch_l["valid"])
            sup, inter, union = _global_outputs(sup, inter, union)
        # the hooks' losses are global values already (hooks/base.py)
        return {"sup_loss": sup, "reg_loss": reg.detach(), "inter": inter,
                "union": union, "hooks": hook_metrics}

    return _spanned_step(step)


def draw_adversarial_params(generator: torch.Generator, batch_l, batch_u,
                            store: Optional[DeviceStore], *, policy: AugmentPolicy) -> Dict:
    """The adversarial step's draws (spcl_tpu steps.py:514-519): {"lab": one
    view of the labeled batch, "unl": one view of the unlabeled batch}."""
    n_l, in_l, sizes_l, device = _global_view(store, batch_l)
    n_u, in_u, sizes_u, _ = _global_view(store, batch_u)
    return {"lab": sample_once(generator, n_l, policy, in_l, sizes=sizes_l, device=device),
            "unl": sample_once(generator, n_u, policy, in_u, sizes=sizes_u, device=device)}


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean sigmoid BCE against a constant label (optax.sigmoid_binary_cross_entropy),
    over the global batch (every rank holds the same number of rows)."""
    share = F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))
    return mesh.global_sum(share / mesh.world_size())


def build_adversarial_step(model: UNet, discriminator: nn.Module,
                           optimizer: torch.optim.Optimizer,
                           discr_optimizer: torch.optim.Optimizer, *, num_classes: int,
                           policy: AugmentPolicy, reg_weight: float,
                           dis_consider_image: bool = False,
                           store: Optional[DeviceStore] = None) -> Callable:
    """Returns step(batch_l, batch_u, generator, params=None) -> {"sup_loss",
    "gen_loss", "dis_loss", "inter", "union"} (detached device tensors).

    The labeled forward, then the unlabeled one (train mode: the running
    statistics move twice, in that order); the generator loss sup +
    reg_weight x BCE(D(softmax(logits_u)), 1) with the discriminator's
    weights before this step; one optimizer step; then the discriminator's
    loss BCE(D(labeled), 1) + BCE(D(unlabeled), 0) on the detached softmaxes,
    its gradients scaled by `reg_weight` before its optimizer (spcl_tpu
    scales the gradients, not the loss, and Adam's eps sees the scale).
    `dis_consider_image` puts the view's image channels before the softmax.
    `reg_weight` 0 skips the unlabeled forward and the discriminator step
    (dis_loss 0), on every rank alike. In a multi-rank run the BCE terms are
    global means and the discriminator's gradients are summed over ranks
    before the `reg_weight` scaling and its Adam step."""
    reg_weight = float(reg_weight)

    def d_input(logits: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(logits, dim=1)
        return torch.cat([image, probs], dim=1) if dis_consider_image else probs

    def step(batch_l, batch_u, generator: Optional[torch.Generator],
             params: Optional[Dict] = None):
        n_l_global, n_u_global = _rows(batch_l), _rows(batch_u)
        if params is None:
            params = draw_adversarial_params(generator, batch_l, batch_u, store, policy=policy)
        batch_l, lab_draws = mesh.shard_rows((batch_l, params["lab"]), n_l_global)
        batch_u, unl_draws = mesh.shard_rows((batch_u, params["unl"]), n_u_global)
        batch_l = _resolve_batch(store, batch_l)
        img_l, lab_l = augment_once(_as_float_image(batch_l["image"]), batch_l["label"].long(),
                                    policy, lab_draws)
        model.train()
        logits_l = model(img_l)["logits"]
        sup = _masked_ce(logits_l, class2one_hot(lab_l, num_classes), batch_l["valid"])
        gen = torch.zeros((), dtype=torch.float32, device=img_l.device)
        if reg_weight > 0:
            batch_u = _resolve_batch(store, batch_u)
            img_u, _ = augment_once(_as_float_image(batch_u["image"]), None, policy,
                                    unl_draws)
            logits_u = model(img_u)["logits"]
            # non-saturating generator objective: D should call it real. Its
            # backward also reaches D's parameters; the discriminator step
            # below sets their gradients afresh
            gen = _bce_with_logits(discriminator(d_input(logits_u, img_u)), 1.0)
        optimizer.zero_grad(set_to_none=True)
        (sup + reg_weight * gen).backward()
        _reduce_gradients(optimizer)
        optimizer.step()
        dis = torch.zeros((), dtype=torch.float32, device=img_l.device)
        if reg_weight > 0:
            dis = (_bce_with_logits(discriminator(d_input(logits_l.detach(), img_l)), 1.0)
                   + _bce_with_logits(discriminator(d_input(logits_u.detach(), img_u)), 0.0))
            discr_optimizer.zero_grad(set_to_none=True)
            dis.backward()
            mesh.all_reduce_grads(list(discriminator.parameters()))
            grads = [p.grad for p in discriminator.parameters() if p.grad is not None]
            torch._foreach_mul_(grads, reg_weight)
            discr_optimizer.step()
        inter, union = dice_stats_from_labels(logits_l.detach().argmax(dim=1), lab_l,
                                              num_classes, batch_l["valid"])
        sup, inter, union = _global_outputs(sup, inter, union)
        return {"sup_loss": sup, "gen_loss": gen.detach(), "dis_loss": dis.detach(),
                "inter": inter, "union": union}

    return _spanned_step(step)
