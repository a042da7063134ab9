"""Hook framework: regularizer plugins summed into the train step's loss.

The counterpart of `spcl_tpu/hooks/base.py` (reference
contrastyou/hooks/base.py:23-118). A `TrainerHook` owns an optional
projector `nn.Module` (built by `build` once the model exists; its
parameters are optimized together with the model's), exposes
`loss_fn(ctx, scalars) -> (weighted_loss, metrics)` called inside each step,
and keeps per-epoch host state (the self-paced gamma) that enters the step
as plain floats through `epoch_scalars()`.

The pretrain step provides a `ctx` dict with:
  acts        {stage: activation} of the step's model forward (NCHW); the
              last 2*n_unl rows are [view 1, view 2]
  n_unl       int — batch size N (slices per view)
  flip        replayable flip params of this step (data/augment.py)
  partition / patient / cycle / scan_idx / valid   [N] meta labels
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


def label_from_contrast_on(ctx: Dict, contrast_on: str) -> torch.Tensor:
    """Meta-label vector for the contrastive loss (reference
    semi_seg/hooks/utils.py:45-65 label generators)."""
    if contrast_on == "partition":
        return ctx["partition"]
    if contrast_on == "patient":
        return ctx["patient"]
    if contrast_on == "cycle":
        return ctx["cycle"]
    if contrast_on in ("self", None):
        # SimCLR: each sample only matches its own second view
        part = ctx["partition"]
        return torch.arange(part.shape[0], dtype=torch.int32, device=part.device)
    raise NotImplementedError(contrast_on)


class TrainerHook:
    """Base. Subclasses override build/loss_fn and the declarations."""

    feature_name: Optional[str] = None  # deepest UNet stage this hook taps

    def __init__(self, name: str, weight: float = 1.0):
        self.name = name
        self.weight = float(weight)
        self.projector: Optional[nn.Module] = None

    # -- setup (once) ---------------------------------------------------------
    def build(self, model: nn.Module, device) -> Optional[nn.Module]:
        """Create (and return) the projector on `device`, or None."""
        return None

    def parameters(self):
        return [] if self.projector is None else list(self.projector.parameters())

    # -- per-epoch (host) -----------------------------------------------------
    def epoch_scalars(self, epoch: int) -> Dict[str, float]:
        return {}

    def on_epoch_end(self) -> None:
        pass

    # -- per-step -------------------------------------------------------------
    def loss_fn(self, ctx: Dict, scalars: Dict[str, float]) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    # -- persistence ----------------------------------------------------------
    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict) -> None:
        pass


class CombineTrainerHook(TrainerHook):
    """Flat container (reference contrastyou/hooks/base.py CombineTrainerHook)."""

    def __init__(self, *hooks: TrainerHook):
        super().__init__(name="combine")
        self.hooks = list(hooks)


def get_individual_hooks(*hooks: TrainerHook) -> List[TrainerHook]:
    out: List[TrainerHook] = []
    for h in hooks:
        if isinstance(h, CombineTrainerHook):
            out.extend(get_individual_hooks(*h.hooks))
        else:
            out.append(h)
    return out
