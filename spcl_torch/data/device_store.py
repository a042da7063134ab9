"""Device-resident dataset store: the whole packed dataset on the card.

The counterpart of `spcl_tpu/data/device_store.py` (`Trainer.device_data`,
which `config/base.yaml` sets for every run). The packed uint8 dataset is
uploaded once; each step then gathers its batch on the device from a [B]
index tensor, so a step's host work holds no batch gather and no batch copy.
The reference's datasets are small (ACDC train is about 125 MB packed), and
a store that does not fit raises (CUDA out of memory): there is no fallback
to the host path.

A `DeviceStore` is built on a ROOT dataset. The labeled, unlabeled,
contrastive and eval subsets sample indices into the same store through
`SliceDataset.to_global`, so one store serves every loader of a root. The
meta labels gathered are the root's: on a subset, `scan_idx` and `patient`
are a relabelling of what `SliceDataset.take` recomputes for the subset (the
same pairs, other numbers), so code that turns a `scan_idx` into a name uses
`root.scan_names`.

In a multi-rank run every rank holds the whole store (spcl_tpu replicates it
over its mesh, device_store.py:37-40) and gathers its own rows.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .dataset import SliceDataset

_META = ("scan_idx", "patient", "partition", "cycle")

# one store per (root dataset, device) in this process
_STORE_CACHE: Dict[Tuple[int, str], "DeviceStore"] = {}


class DeviceStore:
    """The arrays of a root dataset on `device`, in the layout of
    `SliceDataset.batch`: images uint8 [N, C, H, W], labels uint8 [N, H, W],
    sizes int32 [N, 2], the meta labels int32 [N]."""

    def __init__(self, root: SliceDataset, device):
        if root.root is not root:
            raise ValueError("build the store on the ROOT dataset (dataset.root)")
        # the cache keys on id(root), which is only unique while the root
        # lives: holding it keeps a collected root's id from being reused by
        # another dataset that would then be served these arrays
        self.root = root
        self.device = torch.device(device)
        imgs = root.images[:, None] if root.images.ndim == 3 \
            else np.transpose(root.images, (0, 3, 1, 2))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.arrays: Dict[str, torch.Tensor] = {
            "image": put(imgs), "label": put(root.labels),
            "size": put(root.sizes.astype(np.int32)),
            "scan_idx": put(root.scan_index.astype(np.int32)),
            "patient": put(root.patient_index.astype(np.int32)),
            "partition": put(root.partitions.astype(np.int32)),
            "cycle": put(root.cycles.astype(np.int32)),
        }

    @classmethod
    def for_dataset(cls, ds: SliceDataset, device) -> "DeviceStore":
        """The store of `ds.root` on `device`, built on first use."""
        device = torch.device(device)
        key = (id(ds.root), str(device))
        if key not in _STORE_CACHE:
            _STORE_CACHE[key] = cls(ds.root, device)
        return _STORE_CACHE[key]

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self.arrays.values()))

    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        return gather_from(self.arrays, idx)

    def sizes_of(self, idx: torch.Tensor) -> torch.Tensor:
        """[B, 2] stored extents of the slices at `idx` (slice 0's at -1),
        as `gather` returns them."""
        return self.arrays["size"][torch.clamp(idx.long(), min=0)]


def gather_from(arrays: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B] global indices on the device (-1 = padding) -> the batch dict of
    `SliceDataset.batch`, computed on the device without a host
    synchronisation: slice 0 fills a pad entry, whose meta labels are -1 and
    whose `valid` is 0."""
    idx = idx.long()
    pad = idx < 0
    safe = torch.clamp(idx, min=0)
    out = {k: arrays[k][safe] for k in ("image", "label", "size")}
    for k in _META:
        out[k] = arrays[k][safe].masked_fill(pad, -1)
    out["valid"] = (~pad).float()
    return out
