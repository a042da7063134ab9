"""Stage-range freezing — the reference's `set_grad` (reference
semi_seg/arch/unet.py:242-259, used by main_pretrain_encoder.py:65-67 to
freeze everything past Conv5).

`spcl_tpu` zeroes the gradients of frozen stages with a mask; here a frozen
stage is `requires_grad=False`, and the trainer hands the optimizer only
parameters that require gradients, so a frozen stage takes no update and no
weight decay. A range is in the order of the architecture its stage names
belong to (`models/stages.py`; the UNet's where both ends are None).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from torch import nn

from .stages import elements_of
from .unet import ARCH_ELEMENTS


def stages_from_range(start: Optional[str] = None, end: Optional[str] = None,
                      include_start: bool = True, include_end: bool = True) -> List[str]:
    """Stage names in [start, end] with inclusivity flags (reference
    unet.py:34-64 `_complete_arch_start2end`)."""
    if start is None and not include_start:
        raise ValueError("include_start must be True when start is None")
    if end is None and not include_end:
        raise ValueError("include_end must be True when end is None")
    order = elements_of(start or end) if (start or end) else ARCH_ELEMENTS
    start = start or order[0]
    end = end or order[-1]
    if end not in order:
        raise ValueError(f"{start!r} and {end!r} are stages of different architectures")
    si, ei = order.index(start), order.index(end)
    if si > ei:
        raise ValueError((start, end))
    lo = si if include_start else si + 1
    hi = ei + 1 if include_end else ei
    return list(order[lo:hi])


def set_trainable_stages(model: nn.Module, trainable_stages: Iterable[str]) -> None:
    """requires_grad=True on the parameters of `trainable_stages`, False on
    every other stage of the model (`model.ARCH_ELEMENTS`)."""
    trainable = set(trainable_stages)
    for name in model.ARCH_ELEMENTS:
        for p in model.stage(name).parameters():
            p.requires_grad_(name in trainable)
