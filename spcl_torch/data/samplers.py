"""Host-side index samplers.

Capability parity with reference contrastyou/data/sampler.py (Infinite/Scan
batch samplers, :203-284) and semi_seg/data/rearr.py:37-98
(ContrastBatchSampler — the paper's m-scans x partitions batch construction).

These yield numpy index arrays; batches are gathered by SliceDataset.batch
and augmented on device. All randomness comes from a seeded
numpy Generator so epochs are reproducible and resumable. With the same seed
they yield the same index streams as `spcl_tpu.data.samplers`; batches keep
the padded static shapes of that package, so the two stay comparable.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from .dataset import SliceDataset


class InfiniteRandomSampler:
    """Endless stream of fixed-size index batches over reshuffled epochs
    (reference sampler.py:203-223 + DataLoader batching)."""

    def __init__(self, dataset: SliceDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        assert len(dataset) > 0
        self._n = len(dataset)
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._drop_last = drop_last

    def __iter__(self) -> Iterator[np.ndarray]:
        buffer: List[int] = []
        while True:
            order = self._rng.permutation(self._n) if self._shuffle else np.arange(self._n)
            buffer.extend(order.tolist())
            while len(buffer) >= self._batch_size:
                yield np.asarray(buffer[: self._batch_size], np.int64)
                buffer = buffer[self._batch_size:]


class LimitedIterationSampler:
    """Wrap any index iterator, stopping after `stop_iteration` batches
    (reference sampler.py:226-246)."""

    def __init__(self, base_iter: Iterator[np.ndarray], stop_iteration: int):
        self._base = base_iter
        self._stop = stop_iteration

    def __iter__(self):
        for i, batch in enumerate(self._base):
            if i >= self._stop:
                return
            yield batch


class ScanBatchSampler:
    """One batch per scan: all slices of one scan, in slice order — enables
    per-scan 3D dice at eval (reference sampler.py:249-284).

    `pad_to`: optionally right-pad every batch to a fixed size with index -1
    (mapped to a zero `valid` flag downstream) so every batch has one shape.
    """

    def __init__(self, dataset: SliceDataset, shuffle: bool = False, seed: int = 0,
                 pad_to: Optional[int] = None):
        self._dataset = dataset
        self._scan2idx: Dict[str, np.ndarray] = dataset.scan_to_indices()
        self._scans = sorted(self._scan2idx)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._pad_to = pad_to

    @property
    def max_scan_len(self) -> int:
        return max(len(v) for v in self._scan2idx.values())

    def __len__(self) -> int:
        return len(self._scans)

    def __iter__(self) -> Iterator[np.ndarray]:
        scans = list(self._scans)
        if self._shuffle:
            self._rng.shuffle(scans)
        for s in scans:
            idx = self._scan2idx[s]
            if self._pad_to is not None:
                assert len(idx) <= self._pad_to, (s, len(idx), self._pad_to)
                pad = np.full(self._pad_to - len(idx), -1, np.int64)
                idx = np.concatenate([idx, pad])
            yield idx

    def scan_of_batch(self, i: int) -> str:
        # iteration order == self._scans only without shuffling; callers
        # pairing batches with scan names must not use a shuffled sampler
        assert not self._shuffle, \
            "scan_of_batch is undefined under shuffle=True (ADVICE r4)"
        return self._scans[i]


class SequentialBatchSampler:
    """Fixed-size sequential batches with -1 padding on the tail (the
    reference's non-grouped eval path, creator.py:125-127 batch_size=4)."""

    def __init__(self, dataset: SliceDataset, batch_size: int = 4):
        self._n = len(dataset)
        self._batch_size = batch_size

    def __len__(self) -> int:
        return (self._n + self._batch_size - 1) // self._batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        for start in range(0, self._n, self._batch_size):
            idx = np.arange(start, min(start + self._batch_size, self._n))
            if len(idx) < self._batch_size:
                idx = np.concatenate([idx, np.full(self._batch_size - len(idx), -1)])
            yield idx

    def scan_of_batch(self, i: int):
        return None  # per-slice dice (no scan grouping)


class ContrastBatchSampler:
    """The paper's batch construction (reference rearr.py:37-98): sample
    `scan_sample_num` scans, then `partition_sample_num` slices per partition
    per scan. Short picks (a scan missing a partition) are skipped by the
    reference, yielding variable batches; here the batch is padded to
    scan_sample_num * partition_num * partition_sample_num with index -1
    (valid=0 downstream), so every step sees one shape.
    """

    def __init__(self, dataset: SliceDataset, scan_sample_num: int = 10,
                 partition_sample_num: int = 1, shuffle: bool = False, seed: int = 0):
        self._dataset = dataset
        self._scan2idx = dataset.scan_to_indices()
        self._partition2idx = dataset.partition_to_indices()
        self._partitions = sorted(self._partition2idx)
        assert 1 <= scan_sample_num <= len(self._scan2idx), scan_sample_num
        self._scan_sample_num = scan_sample_num
        self._partition_sample_num = partition_sample_num
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        # precompute per-scan-per-partition index pools
        self._pools: Dict[str, Dict[int, np.ndarray]] = {}
        part_sets = {p: set(v.tolist()) for p, v in self._partition2idx.items()}
        for s, sidx in self._scan2idx.items():
            sset = set(sidx.tolist())
            self._pools[s] = {p: np.asarray(sorted(sset & part_sets[p]), np.int64)
                              for p in self._partitions}

    @property
    def batch_size(self) -> int:
        return self._scan_sample_num * len(self._partitions) * self._partition_sample_num

    def __iter__(self) -> Iterator[np.ndarray]:
        scans = sorted(self._scan2idx)
        while True:
            chosen = self._rng.choice(len(scans), size=self._scan_sample_num, replace=False)
            batch: List[int] = []
            for ci in chosen:
                pools = self._pools[scans[ci]]
                for p in self._partitions:
                    pool = pools[p]
                    if len(pool) >= self._partition_sample_num:
                        picks = self._rng.choice(len(pool), size=self._partition_sample_num,
                                                 replace=False)
                        batch.extend(pool[picks].tolist())
                    # else: skipped, padding below (reference rearr.py:67-72 skips too)
            if self._shuffle:
                self._rng.shuffle(batch)
            full = np.full(self.batch_size, -1, np.int64)
            full[: len(batch)] = np.asarray(batch, np.int64)
            yield full
