"""The steps of the main path: contrastive pretrain, fine-tune, eval.

The semantics of `spcl_tpu/training/steps.py`:

- `build_pretrain_step` (reference _PretrainEpocherMixin,
  new_pretrain.py:19-126): two augmented views made on the device, view 2
  additionally flipped with replayable params, one partial forward of both
  views to `until` (train-mode BN), loss = sum of the hooks' losses, one
  optimizer step;
- `build_finetune_step` (reference FineTuneEpocher, new_epocher.py:241-289),
  without hooks: one augmented labeled view, whole UNet in train mode,
  pixel-mean cross-entropy over valid slices, one optimizer step, per-slice
  Dice statistics of the prediction;
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
dict>}` for the fine-tune step — so a test can replay the JAX step's draws
exactly.

In a multi-rank run (`parallel/mesh.py`) the steps keep global-batch
semantics, as `spcl_tpu/training/steps.py:12` states them: every rank is
handed the same GLOBAL batch (or index vector) and makes (or is handed) the
same global draws, computes on its own rows of both (`shard_rows`; an index
vector is cut before its rows are gathered), writes its loss so that the
ranks' gradients sum to the global gradient (a mean over the global count;
`grad_share` inside the contrastive losses), and sums the parameter gradients
over ranks before the optimizer step. BatchNorm statistics span the ranks
(`models/norm.py`). Losses come back as global values, per-slice Dice
statistics gathered in global row order, identical on every rank. In one
process all of this is the identity.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

import torch.nn.functional as F

from ..data.augment import (AugmentPolicy, apply_flip, apply_geometric, augment_once,
                            augment_twice, center_geometric, flip_params, frame_pixel_mask,
                            sample_once, sample_twice)
from ..data.device_store import DeviceStore
from ..hooks.base import TrainerHook
from ..losses.functional import class2one_hot
from ..meters.dice import dice_stats_from_labels
from ..models.unet import UNet
from ..parallel import mesh

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
                         flip_threshold: float = 0.8) -> Dict:
    """The pretrain step's draws for a global batch: {"aug": <sample_twice
    dict>, "flip": <flip_params dict>}."""
    n, in_size, sizes, device = _global_view(store, batch)
    return {"aug": sample_twice(generator, n, policy, in_size, total_freedom=total_freedom,
                                sizes=sizes, device=device),
            "flip": flip_params(generator, n, threshold=flip_threshold, device=device)}


def _as_float_image(img: torch.Tensor) -> torch.Tensor:
    """Batches ship images as packed uint8; scale to [0, 1] float on the
    device. Float inputs pass through."""
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
    "hooks": {name: {...}}} — so the caller decides when to synchronise."""
    hooks = tuple(hooks)

    def step(batch, generator: Optional[torch.Generator],
             hook_scalars: Dict[str, Dict[str, float]], params: Optional[Dict] = None):
        n_global = _rows(batch)
        if params is None:
            params = draw_pretrain_params(generator, batch, store, policy=policy,
                                          total_freedom=total_freedom,
                                          flip_threshold=flip_threshold)
        batch, params = mesh.shard_rows((batch, params), n_global)
        batch = _resolve_batch(store, batch)
        image = _as_float_image(batch["image"])
        n = image.shape[0]
        (v1, _), (v2, _) = augment_twice(image, None, policy, params["aug"])
        fp = params["flip"]
        v2 = apply_flip(v2, fp)
        model.train()
        acts = model(torch.cat([v1, v2], dim=0), until=until)
        ctx = {"acts": acts, "n_unl": n, "flip": fp}
        ctx.update({k: batch[k] for k in _META_KEYS})
        total = torch.zeros((), dtype=torch.float32, device=image.device)
        hook_metrics = {}
        for h in hooks:
            loss, m = h.loss_fn(ctx, hook_scalars.get(h.name, {}))
            total = total + loss
            hook_metrics[h.name] = {k: v.detach() if torch.is_tensor(v) else v
                                    for k, v in m.items()}
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        _reduce_gradients(optimizer)
        optimizer.step()
        return {"reg_loss": total.detach(), "hooks": hook_metrics}

    return step


def _reduce_gradients(optimizer: torch.optim.Optimizer) -> None:
    """Sum the parameter gradients over ranks (no-op in one process)."""
    mesh.all_reduce_grads([p for g in optimizer.param_groups for p in g["params"]])


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
    frame pixels. Eval mode takes the UNet's plain path whatever
    `small_c_layout` is."""
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


def build_finetune_step(model: UNet, optimizer: torch.optim.Optimizer, *, num_classes: int,
                        policy: AugmentPolicy, store: Optional[DeviceStore] = None) -> Callable:
    """Returns step(batch, generator, params=None) -> {"sup_loss", "inter",
    "union"} (detached device tensors): the labeled-only step."""

    def step(batch, generator: Optional[torch.Generator], params: Optional[Dict] = None):
        n_global = _rows(batch)
        if params is None:
            _, in_size, sizes, device = _global_view(store, batch)
            params = {"aug": sample_once(generator, n_global, policy, in_size, sizes=sizes,
                                         device=device)}
        batch, params = mesh.shard_rows((batch, params), n_global)
        batch = _resolve_batch(store, batch)
        image = _as_float_image(batch["image"])
        img, lab = augment_once(image, batch["label"].long(), policy, params["aug"])
        model.train()
        logits = model(img)["logits"]
        sup = _masked_ce(logits, class2one_hot(lab, num_classes), batch["valid"])
        optimizer.zero_grad(set_to_none=True)
        sup.backward()
        _reduce_gradients(optimizer)
        optimizer.step()
        inter, union = dice_stats_from_labels(logits.detach().argmax(dim=1), lab,
                                              num_classes, batch["valid"])
        sup, inter, union = _global_outputs(sup, inter, union)
        return {"sup_loss": sup, "inter": inter, "union": union}

    return step
