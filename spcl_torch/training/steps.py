"""The contrastive pretrain step.

The semantics of `spcl_tpu/training/steps.py::build_pretrain_step`
(reference _PretrainEpocherMixin, new_pretrain.py:19-126): two augmented
views made on the device, view 2 additionally flipped with replayable
params, one partial forward of both views to `until` (train-mode BN), loss =
sum of the hooks' losses, one optimizer step.

Randomness comes from the step's `torch.Generator`. A caller may instead
inject the drawn values — `params={"aug": <sample_twice dict>, "flip":
<flip_params dict>}` — so a test can replay the JAX step's draws exactly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..data.augment import AugmentPolicy, apply_flip, augment_twice, flip_params, sample_twice
from ..hooks.base import TrainerHook
from ..models.unet import UNet

_META_KEYS = ("partition", "patient", "cycle", "scan_idx", "valid")


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Host batch dict (numpy) -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _as_float_image(img: torch.Tensor) -> torch.Tensor:
    """Batches ship images as packed uint8; scale to [0, 1] float on the
    device. Float inputs pass through."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img.float()


def build_pretrain_step(model: UNet, hooks: Sequence[TrainerHook],
                        optimizer: torch.optim.Optimizer, *, policy: AugmentPolicy,
                        total_freedom: bool, until: Optional[str],
                        flip_threshold: float = 0.8) -> Callable:
    """Returns step(batch, generator, hook_scalars, params=None) -> metrics.

    `batch` holds device tensors (`batch_to_device`); metrics are detached
    device tensors — {"reg_loss": ..., "hooks": {name: {...}}} — so the
    caller decides when to synchronise."""
    hooks = tuple(hooks)

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             hook_scalars: Dict[str, Dict[str, float]], params: Optional[Dict] = None):
        image = _as_float_image(batch["image"])
        n, device = image.shape[0], image.device
        if params is None:
            params = {
                "aug": sample_twice(generator, n, policy, image.shape[-1],
                                    total_freedom=total_freedom,
                                    sizes=batch.get("size"), device=device),
                "flip": flip_params(generator, n, threshold=flip_threshold, device=device),
            }
        (v1, _), (v2, _) = augment_twice(image, None, policy, params["aug"])
        fp = params["flip"]
        v2 = apply_flip(v2, fp)
        model.train()
        acts = model(torch.cat([v1, v2], dim=0), until=until)
        ctx = {"acts": acts, "n_unl": n, "flip": fp}
        ctx.update({k: batch[k] for k in _META_KEYS})
        total = torch.zeros((), dtype=torch.float32, device=device)
        hook_metrics = {}
        for h in hooks:
            loss, m = h.loss_fn(ctx, hook_scalars.get(h.name, {}))
            total = total + loss
            hook_metrics[h.name] = {k: v.detach() if torch.is_tensor(v) else v
                                    for k, v in m.items()}
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        return {"reg_loss": total.detach(), "hooks": hook_metrics}

    return step
