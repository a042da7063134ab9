"""Hook framework: regularizer plugins summed into the train step's loss.

The counterpart of `spcl_tpu/hooks/base.py` (reference
contrastyou/hooks/base.py:23-118). A `TrainerHook` owns an optional
projector `nn.Module` (built by `build` once the model exists; its
parameters are optimized together with the model's), exposes
`loss_fn(ctx, scalars) -> (weighted_loss, metrics)` called inside each step,
and keeps per-epoch host state (the self-paced gamma) that enters the step
as plain floats through `epoch_scalars()`.

A hook that draws random numbers inside the step (mixup's lambda and
permutation, UC-MT's noise) does so in `sample(generator, ctx)`; the step
calls it once per step, or takes the draws the caller injected, and hands
them to `loss_fn` as `ctx["draws"][hook.name]`.

In a multi-rank run (`Trainer.mesh`) `ctx` holds this rank's rows, the draws
are the global batch's, and every `loss_fn` returns the GLOBAL loss on every
rank with the gradient convention of `parallel/mesh.py` (the ranks'
gradients sum to the global loss's gradient): a masked mean is this rank's
partial sum over the global count through `mesh.global_sum`; a loss that is
not separable over the batch (IIC's joint, MINE's roll, mixup's
permutation, InfoNCE) gathers or sums what it needs and enters the backward
through `mesh.grad_share`. Its metrics are global values too.

The steps provide a `ctx` dict with (the keys of spcl_tpu/hooks/base.py:
21-35; all tensors NCHW, the class axis second):
  acts        {stage: activation} of the step's model forward; the last
              2*n_unl rows are [view 1, view 2] (pretrain) or [unlabeled,
              unlabeled_tf] (semi)
  n_unl       int — unlabeled batch size N (slices per view) of this rank
  n_global, row_offset   int — the global batch's N and this rank's first
              row in it (a multi-rank run, `parallel/mesh.py`; without them
              N and 0). `sample` draws for the global batch, as one process
              does, and `loss_fn` keeps this rank's rows of the draws
  flip        replayable flip params of this step (data/augment.py)
  partition / patient / cycle / scan_idx / valid   [N] meta labels
  draws       {hook name: what its `sample` drew}
semi and mixup steps also:
  unlabeled_tf_logits, unlabeled_logits_tf    [N, C, h, w]: the student on
              the transformed batch, and its prediction on the plain batch
              flipped into the transformed frame
  unlabeled_image, unlabeled_image_tf
  apply_student      fn(images) -> logits, the student in train mode with its
                     BatchNorm statistics frozen (gradients flow)
  teacher_logits_tf  the EMA teacher on the plain batch, flipped (if any
                     hook needs_teacher), and apply_teacher(images) -> logits
  labeled_image, labeled_onehot (+ labeled_image_tf, labeled_onehot_tf
                     with a mixup hook)
  num_classes        int
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..parallel import mesh
from ..utils.profiling import span


def global_rows(ctx: Dict, n_local: int) -> Tuple[int, int]:
    """(N of the global batch, this rank's first row in it) of the step's
    unlabeled (contrastive) rows, `n_local` of them on this rank."""
    return int(ctx.get("n_global", n_local)), int(ctx.get("row_offset", 0))


def own_rows(draw: torch.Tensor, ctx: Dict, n_local: int, axis: int = 0) -> torch.Tensor:
    """This rank's rows (along `axis`) of a draw made for the global batch."""
    _, offset = global_rows(ctx, n_local)
    return draw.narrow(axis, offset, n_local)


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
        # SimCLR: each sample only matches its own second view. In a
        # multi-rank run ctx holds this rank's rows: the ids stay unique
        # over the global batch (spcl_tpu gradcache.py `_target`)
        part = ctx["partition"]
        n = part.shape[0]
        return torch.arange(mesh.rank() * n, (mesh.rank() + 1) * n, dtype=torch.int32,
                            device=part.device)
    raise NotImplementedError(contrast_on)


class TrainerHook:
    """Base. Subclasses override build/loss_fn and the declarations."""

    needs_teacher: bool = False  # the step keeps an EMA teacher for this hook
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
        """The end of an epoch: `step_schedulers` in the span
        `spcl.epoch.schedule`."""
        with span("spcl.epoch.schedule"):
            self.step_schedulers()

    def step_schedulers(self) -> None:
        """Step the hook's per-epoch schedulers (a subclass's override)."""

    # -- per-step -------------------------------------------------------------
    def sample(self, generator: Optional[torch.Generator], ctx: Dict) -> Optional[Dict]:
        """This step's random draws (None: the hook draws nothing)."""
        return None

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
