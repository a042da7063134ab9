"""Per-scan (3D) Dice meter.

The counterpart of `spcl_tpu/meters/dice.py` (reference
contrastyou/meters/general_dice_meter.py:19-171, `UniversalDice`): per-slice
per-class intersection/union accumulated and grouped by scan name; per-scan
Dice = (2*sum(I)+1e-6)/(sum(U)+1e-6); report `DSC{i}` per reported class plus
`DSC_mean`. The per-slice sums are computed on the device inside the step
(`dice_stats_from_labels`); the meter aggregates small [B, C] arrays by group
on the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .metric import Metric


def dice_stats_from_labels(pred_labels: torch.Tensor, target_labels: torch.Tensor,
                           num_classes: int, valid: Optional[torch.Tensor] = None,
                           pixel_mask: Optional[torch.Tensor] = None):
    """[B, H, W] int labels -> ([B, C] intersection, [B, C] union).

    `valid` ([B] 1/0) zeroes padded slices so padded eval batches are exact.
    `pixel_mask` ([B, H, W] 1/0) restricts the statistics to in-frame pixels
    (the shortest-side val-resize path pads non-square frames)."""
    classes = torch.arange(num_classes, device=pred_labels.device)
    p = (pred_labels[..., None] == classes).float()
    t = (target_labels[..., None] == classes).float()
    if pixel_mask is not None:
        p = p * pixel_mask[..., None]
        t = t * pixel_mask[..., None]
    inter = (p * t).sum(dim=(1, 2))
    union = (p + t).sum(dim=(1, 2))
    if valid is not None:
        inter = inter * valid[:, None]
        union = union * valid[:, None]
    return inter, union


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class UniversalDice(Metric):
    def __init__(self, C: int = 4, report_axises: Sequence[int] = None):
        super().__init__(threaded=False)
        if report_axises is not None and max(report_axises) > C:
            raise ValueError(f"report_axises {report_axises} beyond C={C}")
        self._C = C
        self._report_axis = list(report_axises) if report_axises is not None else list(range(C))
        self.reset()

    def reset(self):
        self._inter: List[np.ndarray] = []
        self._union: List[np.ndarray] = []
        self._group_names: List[str] = []
        self._n = 0

    def _add(self, inter, union, group_name: Union[str, Sequence[str], None] = None):
        """inter/union: [B, C] arrays from `dice_stats_from_labels`."""
        inter, union = _numpy(inter), _numpy(union)
        b = inter.shape[0]
        if group_name is None:
            names = [f"{self._n}_{i:03d}" for i in range(b)]  # per-slice dice
        elif isinstance(group_name, str):
            names = [group_name] * b  # whole batch is one scan -> 3D dice
        else:
            names = list(group_name)
            if len(names) != b:
                raise ValueError(f"{len(names)} group names for {b} slices")
        self._inter.append(inter)
        self._union.append(union)
        self._group_names.extend(names)
        self._n += 1

    def add_labels(self, pred_labels, target_labels, group_name=None, valid=None):
        """Convenience: accept label maps directly (arrays or tensors)."""
        inter, union = dice_stats_from_labels(
            torch.as_tensor(_numpy(pred_labels)), torch.as_tensor(_numpy(target_labels)),
            self._C, None if valid is None else torch.as_tensor(_numpy(valid)).float())
        inter, union = _numpy(inter), _numpy(union)
        if valid is not None and group_name is not None and not isinstance(group_name, str):
            keep = _numpy(valid).astype(bool)
            inter, union = inter[keep], union[keep]
            group_name = [g for g, k in zip(group_name, keep) if k]
        self._add(inter, union, group_name)

    @property
    def group_names(self) -> List[str]:
        return sorted(set(self._group_names))

    def per_group_dice(self) -> Dict[str, np.ndarray]:
        if self._n == 0:
            return {}
        inter = np.concatenate(self._inter, axis=0)
        union = np.concatenate(self._union, axis=0)
        names = np.asarray(self._group_names)
        out = {}
        for g in self.group_names:
            idx = names == g
            out[g] = (2 * inter[idx].sum(0) + 1e-6) / (union[idx].sum(0) + 1e-6)
        return out

    def value(self):
        if self._n == 0:
            return np.full(self._C, np.nan), np.full(self._C, np.nan)
        per_group = np.stack(list(self.per_group_dice().values()), axis=0)
        return per_group.mean(0), per_group.std(0)

    def _summary(self) -> Dict[str, float]:
        means, _ = self.value()
        report = {f"DSC{i}": float(means[i]) for i in self._report_axis}
        report["DSC_mean"] = float(np.mean(list(report.values())))
        return report
