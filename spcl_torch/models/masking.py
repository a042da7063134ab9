"""Stage-range freezing — the reference's `set_grad` (reference
semi_seg/arch/unet.py:242-259, used by main_pretrain_encoder.py:65-67 to
freeze everything past Conv5).

`spcl_tpu` zeroes the gradients of frozen stages with a mask; here a frozen
stage is `requires_grad=False`, and the trainer hands the optimizer only
parameters that require gradients, so a frozen stage takes no update and no
weight decay.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from .unet import ARCH_ELEMENTS, UNet, arch_order


def stages_from_range(start: Optional[str] = None, end: Optional[str] = None,
                      include_start: bool = True, include_end: bool = True) -> List[str]:
    """Stage names in [start, end] with inclusivity flags (reference
    unet.py:34-64 `_complete_arch_start2end`)."""
    if start is None and not include_start:
        raise ValueError("include_start must be True when start is None")
    if end is None and not include_end:
        raise ValueError("include_end must be True when end is None")
    start = start or "Conv1"
    end = end or "Deconv_1x1"
    si, ei = arch_order(start), arch_order(end)
    if si > ei:
        raise ValueError((start, end))
    lo = si if include_start else si + 1
    hi = ei + 1 if include_end else ei
    return list(ARCH_ELEMENTS[lo:hi])


def set_trainable_stages(model: UNet, trainable_stages: Iterable[str]) -> None:
    """requires_grad=True on the parameters of `trainable_stages`, False on
    every other stage."""
    trainable = set(trainable_stages)
    for name in ARCH_ELEMENTS:
        for p in model.stage(name).parameters():
            p.requires_grad_(name in trainable)
