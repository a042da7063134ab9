"""What `Trainer.defer_reads` keeps on the device: the counterparts of
spcl_tpu's `_device_val_score`, `_update_best` and the end-of-run drain
(training/trainer.py:732-882).

- `device_val_score`: the val DSC_mean of `UniversalDice` (per-scan Dice
  (2 sum I + 1e-6) / (sum U + 1e-6), mean over scans, mean over the reported
  classes 1..C-1) from an eval epoch's [batches, B, C] statistics, in float32
  on the device. The slices' scans are known on the host (the batches'
  index rows and scan names), so any batching works: per-scan batches or
  `Trainer.packed_eval`.
- `DeviceBest`: the checkpoint state of the best epoch so far. Its tensors
  on the training device (weights, BatchNorm buffers, optimizer moments,
  projectors, the EMA teacher) are chosen by a select on the device,
  torch.where(score > best, new, best); everything else (step counts, hook
  schedulers, generator and sampler states, learning rates) is copied on the
  host every epoch, and the drain picks the best epoch's copy.
- `drain`: one device -> host copy per leaf of a list of equally shaped
  metric trees (one per epoch), stacked on the device first, in the span
  `spcl.epoch.drain`.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import span

Path_ = Tuple


def _leaves(tree, path: Path_ = ()):
    """(path, leaf) of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map(tree, fn, path: Path_ = ()):
    """The tree with every leaf replaced by fn(path, leaf); containers copied."""
    if isinstance(tree, dict):
        out = type(tree)((k, _map(v, fn, path + (k,))) for k, v in tree.items())
        if hasattr(tree, "__dict__"):  # a state_dict's `_metadata`
            out.__dict__.update(copy.deepcopy(tree.__dict__))
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _upload(values: Sequence[int], device: torch.device) -> torch.Tensor:
    """Host integers as a long tensor on `device`, copied from pinned memory
    without a host wait on a card."""
    t = torch.as_tensor(values, dtype=torch.long)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def device_val_score(out: Dict[str, torch.Tensor], rows: Sequence, groups: Sequence,
                     num_classes: int) -> torch.Tensor:
    """float32 DSC_mean on the device of an eval epoch: `out` holds "inter" and
    "union" [batches, B, C]; rows[b] the batch's index row (-1 = padding),
    groups[b] its scan name or a name per slice (packed eval)."""
    inter, union = out["inter"], out["union"]
    device, width = inter.device, inter.shape[1]
    flat, names = [], []
    for b, (row, group) in enumerate(zip(rows, groups)):
        for i, keep in enumerate(np.asarray(row) >= 0):
            if keep:
                flat.append(b * width + i)
                names.append(group[i] if isinstance(group, list) else group)
    scans = sorted(set(names))
    scan_of = _upload([scans.index(n) for n in names], device)
    idx = _upload(flat, device)
    per_scan = [torch.zeros(len(scans), num_classes, dtype=torch.float32, device=device)
                .index_add_(0, scan_of, t.reshape(-1, num_classes)[idx].float())
                for t in (inter, union)]
    dsc = (2.0 * per_scan[0] + 1e-6) / (per_scan[1] + 1e-6)
    return dsc[:, 1:].mean()


class DeviceBest:
    """The best epoch's checkpoint state, its device tensors selected on the
    device (no host read), its host leaves kept per epoch."""

    def __init__(self, device: torch.device, score: float = -np.inf):
        self._device = torch.device(device)
        self._start = float(score)
        self.score = None
        self._tensors: Dict[Path_, torch.Tensor] = {}
        self._host: Dict[int, object] = {}

    def _on_device(self, leaf) -> bool:
        return torch.is_tensor(leaf) and leaf.device.type == self._device.type

    def update(self, epoch: int, score: torch.Tensor, state: Dict) -> None:
        """Keep `state` (a checkpoint state of `epoch`) where `score` beats
        the best so far; the host leaves of every epoch are kept."""
        if self.score is None:
            self.score = torch.full((), self._start, dtype=torch.float32, device=score.device)
        better = score > self.score
        self.score = torch.where(better, score, self.score)
        for path, leaf in _leaves(state):
            if not self._on_device(leaf):
                continue
            old = self._tensors.get(path)
            self._tensors[path] = (leaf.detach().clone() if old is None
                                   else torch.where(better, leaf.detach(), old))
        self._host[epoch] = _map(state, lambda p, leaf: None if self._on_device(leaf)
                                 else copy.deepcopy(leaf))

    def state(self, epoch: int) -> Dict:
        """The kept checkpoint state: host leaves of `epoch` (the best one, as
        the drain finds it), device tensors copied to the host."""
        tensors = {p: t.cpu() for p, t in self._tensors.items()}
        return _map(self._host[epoch], lambda p, leaf: tensors[p] if p in tensors else leaf)


def drain(trees: List) -> List:
    """Host (numpy) copies of equally shaped trees of device tensors: each
    leaf stacked over the trees on the device and copied once."""
    if not trees:
        return []
    with span("spcl.epoch.drain"):
        flat = [dict(_leaves(t)) for t in trees]
        host = {}
        for p in flat[0]:
            leaves = [f[p] for f in flat]
            if torch.is_tensor(leaves[0]):
                host[p] = torch.stack([t.detach() for t in leaves]).cpu().numpy()
            else:  # already on the host
                host[p] = leaves
        return [_map(trees[0], lambda p, _: host[p][e]) for e in range(len(trees))]
