"""One-hot helper (`spcl_tpu/losses/functional.py:7`; the rest of that
module belongs to hooks that are not ported yet)."""
from __future__ import annotations

import torch


def class2one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer label map [B, ...] -> one-hot [B, C, ...] float32
    (channel-second, as the torch reference; `spcl_tpu` is channel-last)."""
    classes = torch.arange(num_classes, device=labels.device)
    shape = (1, num_classes) + (1,) * (labels.dim() - 1)
    return (labels[:, None] == classes.reshape(shape)).float()
