"""Host batching: a dataset plus an index sampler.

Decoding already happened at pack time, so "loading" is a numpy gather; the
trainer copies each batch to the device itself.
"""
from __future__ import annotations

from .dataset import SliceDataset


class HostLoader:
    """Iterate batch dicts (optionally with filenames) over a dataset with an
    index sampler."""

    def __init__(self, dataset: SliceDataset, sampler, with_filenames: bool = False):
        self._dataset = dataset
        self._sampler = sampler
        self._with_filenames = with_filenames

    @property
    def dataset(self) -> SliceDataset:
        return self._dataset

    @property
    def sampler(self):
        return self._sampler

    def __len__(self):
        # infinite samplers have no len; mirror torch DataLoader's TypeError
        return len(self._sampler)  # type: ignore[arg-type]

    def __iter__(self):
        for idx in self._sampler:
            batch = self._dataset.batch(idx)
            if self._with_filenames:
                yield batch, self._dataset.batch_filenames(idx)
            else:
                yield batch
