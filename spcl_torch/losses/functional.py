"""One-hot / simplex helpers (`spcl_tpu/losses/functional.py`, deepclustering2
parity). The class axis is 1 (NCHW), where `spcl_tpu` puts it last."""
from __future__ import annotations

import torch


def class2one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer label map [B, ...] -> one-hot [B, C, ...] float32
    (channel-second, as the torch reference; `spcl_tpu` is channel-last)."""
    classes = torch.arange(num_classes, device=labels.device)
    shape = (1, num_classes) + (1,) * (labels.dim() - 1)
    return (labels[:, None] == classes.reshape(shape)).float()


def simplex(probs: torch.Tensor, axis: int = 1, atol: float = 1e-4) -> bool:
    """Host-side check that `probs` sums to one along `axis` (debug use)."""
    s = probs.detach().sum(dim=axis).double()
    return bool(torch.allclose(s, torch.ones_like(s), atol=atol))


def one_hot_check(t: torch.Tensor, axis: int = 1) -> bool:
    t = t.detach()
    binary = bool(((t == 0) | (t == 1)).all())
    s = t.sum(dim=axis).double()
    return binary and bool(torch.allclose(s, torch.ones_like(s)))


def probs2one_hot(probs: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """The one-hot map of the argmax along `axis`, class axis at `axis`."""
    onehot = class2one_hot(probs.argmax(dim=axis), probs.shape[axis])
    return torch.movedim(onehot, 1, axis)
