"""Packed-array slice dataset with scan grouping and meta-labels.

Replaces the reference's folder-of-PNGs `DatasetBase`
(contrastyou/data/dataset/base.py:59-227) + the `ContrastDataset` meta-label
mixin (semi_seg/data/dataset.py:16-157). Slices live in one contiguous
uint8 array (packed offline, data/packing.py), metadata (scan ids, partition,
cardiac cycle) are precomputed int vectors, and augmentation runs on the
device. Host code only does indexing. Batches are NCHW: [B, C, H, W] images.

Partition semantics match the reference exactly:
- acdc (partition_num=3, dataset.py:34-43): cut = scan_len // 3;
  idx <= cut-1 -> 0; idx <= 2*cut -> 1; else 2.
- others (dataset.py:66-71): partition = idx // (scan_len // partition_num + 1).
Cardiac cycle (ACDC): scan "patientXXX_00" -> 0 (ED), else 1 (ES)
(semi_seg/epochers/helper.py:58-60).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from ..constants import DATASET_SPECS


def scan_name_from_stem(stem: str, scan_re: str) -> str:
    m = re.compile(scan_re).search(stem)
    if m is None:
        raise ValueError(f"cannot extract scan name from {stem!r} with {scan_re!r}")
    return m.group(0)


def slice_index_from_stem(stem: str) -> int:
    nums = re.compile(r"\d+").findall(stem)
    if not nums:
        raise ValueError(f"no slice index in {stem!r}")
    return int(nums[-1])


def compute_partition(slice_idx: int, scan_len: int, partition_num: int,
                      style: str = "div") -> int:
    if style == "acdc":
        cut = scan_len // partition_num  # partition_num == 3
        if slice_idx <= cut - 1:
            return 0
        if slice_idx <= 2 * cut:
            return 1
        return 2
    cut = scan_len // partition_num
    return slice_idx // (cut + 1)


@dataclass
class SliceDataset:
    """All 2D slices of one split, packed.

    images: [N, H, W] uint8 (or float32 in [0,1]); labels: [N, H, W] uint8.
    """
    name: str                     # dataset name, key into DATASET_SPECS
    images: np.ndarray
    labels: np.ndarray
    filenames: List[str]          # slice stems, e.g. patient100_00_09
    # [N, 2] int32 original (h, w) of each slice inside its square canvas
    # (packing stores slices centered, zero-padded); drives the faithful
    # Resize policies (reference semi_seg/augment.py:57,106). Defaults to
    # the full canvas (synthetic data is generated at canvas size).
    sizes: np.ndarray = field(default=None)
    scan_names: List[str] = field(default=None)
    partitions: np.ndarray = field(default=None)   # [N] int32
    cycles: np.ndarray = field(default=None)       # [N] int32 (ACDC ED/ES; zeros otherwise)
    scan_index: np.ndarray = field(default=None)   # [N] int32 index into unique_scans
    unique_scans: List[str] = field(default=None)
    patient_index: np.ndarray = field(default=None)  # [N] int32; ACDC: patientXXX (cycle stripped)
    global_indices: np.ndarray = field(default=None)  # [N] rows in the ROOT dataset
    root: "SliceDataset" = field(default=None, repr=False)  # dataset this was subset from

    def __post_init__(self):
        spec = DATASET_SPECS[self.name]
        n = len(self.filenames)
        assert self.images.shape[0] == n and self.labels.shape[0] == n
        if self.sizes is None:
            h, w = self.images.shape[1], self.images.shape[2]
            self.sizes = np.tile(np.asarray([[h, w]], np.int32), (n, 1))
        if self.scan_names is None:
            self.scan_names = [scan_name_from_stem(f, spec["scan_re"]) for f in self.filenames]
        if self.unique_scans is None:
            self.unique_scans = sorted(set(self.scan_names))
        scan2idx = {s: i for i, s in enumerate(self.unique_scans)}
        if self.scan_index is None:
            self.scan_index = np.asarray([scan2idx[s] for s in self.scan_names], np.int32)
        if self.partitions is None:
            scan_len: Dict[str, int] = {}
            for s in self.scan_names:
                scan_len[s] = scan_len.get(s, 0) + 1
            self.partitions = np.asarray([
                compute_partition(slice_index_from_stem(f), scan_len[s],
                                  spec["partition_num"], spec["partition_style"])
                for f, s in zip(self.filenames, self.scan_names)], np.int32)
        if self.cycles is None:
            if spec["has_cycle"]:
                # scan name patientXXX_EE: EE == "00" -> ED(0), else ES(1)
                self.cycles = np.asarray(
                    [0 if s.split("_")[-1] == "00" else 1 for s in self.scan_names], np.int32)
            else:
                self.cycles = np.zeros(n, np.int32)
        if self.patient_index is None:
            # reference get_label (semi_seg/hooks/utils.py:48-58): acdc patient
            # id strips the cycle suffix; other datasets use the scan id
            if spec["has_cycle"]:
                patients = [s.split("_")[0] for s in self.scan_names]
            else:
                patients = list(self.scan_names)
            p2i = {p: i for i, p in enumerate(sorted(set(patients)))}
            self.patient_index = np.asarray([p2i[p] for p in patients], np.int32)
        if self.global_indices is None:
            self.global_indices = np.arange(n, dtype=np.int64)
        if self.root is None:
            self.root = self

    # -- reference-api parity helpers -------------------------------------------------
    def __len__(self) -> int:
        return len(self.filenames)

    def get_scan_list(self) -> List[str]:
        return list(self.unique_scans)

    def show_scan_names(self) -> List[str]:
        return list(self.scan_names)

    def show_partitions(self) -> List[int]:
        return self.partitions.tolist()

    @property
    def spec(self) -> dict:
        return DATASET_SPECS[self.name]

    @property
    def num_classes(self) -> int:
        return self.spec["num_classes"]

    def scan_to_indices(self) -> Dict[str, np.ndarray]:
        out: Dict[str, List[int]] = {s: [] for s in self.unique_scans}
        for i, s in enumerate(self.scan_names):
            out[s].append(i)
        return {k: np.asarray(v, np.int64) for k, v in out.items()}

    def partition_to_indices(self) -> Dict[int, np.ndarray]:
        out: Dict[int, List[int]] = {}
        for i, p in enumerate(self.partitions.tolist()):
            out.setdefault(p, []).append(i)
        return {k: np.asarray(v, np.int64) for k, v in out.items()}

    def take(self, indices: Sequence[int]) -> "SliceDataset":
        idx = np.asarray(indices, np.int64)
        return SliceDataset(
            name=self.name,
            images=self.images[idx],
            labels=self.labels[idx],
            filenames=[self.filenames[i] for i in idx],
            sizes=self.sizes[idx],
            scan_names=[self.scan_names[i] for i in idx],
            partitions=self.partitions[idx],
            cycles=self.cycles[idx],
            global_indices=self.global_indices[idx],
            root=self.root,
        )

    def to_global(self, local_indices: np.ndarray) -> np.ndarray:
        """Map (possibly -1-padded) local indices to rows of the root dataset."""
        local = np.asarray(local_indices, np.int64)
        safe = np.where(local >= 0, local, 0)
        return np.where(local >= 0, self.global_indices[safe], -1)

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Gather a host batch dict ready to copy to the device.

        images as [B, C, H, W] (NCHW, ToTensor layout); meta labels as int32
        vectors. Index -1 marks padding (valid=0): slice 0 is substituted as
        filler and padded entries get meta label -1 so they never pair as
        positives.
        """
        raw = np.asarray(indices, np.int64)
        valid = (raw >= 0).astype(np.float32)
        idx = np.where(raw >= 0, raw, 0)
        imgs = self.images[idx]
        # images/labels ship in their packed uint8 form — 4x less host-to-
        # device traffic; the step casts and scales on the device
        if imgs.ndim == 3:  # single-modality [B,H,W] -> add channel axis;
            imgs = imgs[:, None]  # multi-modal packs store [N,H,W,C]
        else:
            imgs = np.ascontiguousarray(np.transpose(imgs, (0, 3, 1, 2)))
        pad_meta = raw < 0
        return {
            "image": imgs,
            "label": self.labels[idx],
            "size": self.sizes[idx].astype(np.int32),
            "scan_idx": np.where(pad_meta, -1, self.scan_index[idx]).astype(np.int32),
            "patient": np.where(pad_meta, -1, self.patient_index[idx]).astype(np.int32),
            "partition": np.where(pad_meta, -1, self.partitions[idx]).astype(np.int32),
            "cycle": np.where(pad_meta, -1, self.cycles[idx]).astype(np.int32),
            "valid": valid,
        }

    def batch_filenames(self, indices: Sequence[int]) -> List[str]:
        return [self.filenames[i] if i >= 0 else "<pad>" for i in np.asarray(indices, np.int64)]


def extract_sub_dataset_based_on_scan_names(dataset: SliceDataset,
                                            group_names: Sequence[str]) -> SliceDataset:
    """Reference contrastyou/data/dataset/base.py parity: keep only given scans."""
    wanted = set(group_names)
    idx = [i for i, s in enumerate(dataset.scan_names) if s in wanted]
    return dataset.take(idx)
