"""Host batching, and the prefetch that copies host batches to the device.

Decoding already happened at pack time, so "loading" is a numpy gather.
`device_prefetch` is the counterpart of `spcl_tpu/data/loader.py:48-79`: it
serves the `Trainer.device_data: false` path, keeping `depth` batches in
flight so that the host gather and the copy overlap the device's work.
"""
from __future__ import annotations

import threading
from queue import Empty, Full, Queue
from typing import Iterator

import numpy as np
import torch

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


def device_prefetch(iterator: Iterator, device, depth: int = 3) -> Iterator:
    """Yield the items of `iterator` (host batch dicts of numpy arrays, or
    (batch, extra) tuples whose `extra` passes through untouched) with the
    batch as tensors on `device`, in order and unchanged.

    A producer thread gathers up to `depth` batches ahead. On a CUDA device
    it copies each array into pinned host memory and from there to the card
    on a side stream (`non_blocking`); each batch records an event on that
    stream, which the consumer's stream waits on before the batch is
    handed out. On any other device the arrays become tensors in the
    producer thread. Leaving the loop early stops the producer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "Queue" = Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def to_device(batch):
        if not cuda:
            return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}, None
        with torch.cuda.device(device), torch.cuda.stream(side):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def producer():
        try:
            for item in iterator:
                batch, extra = item if isinstance(item, tuple) else (item, None)
                if not put((to_device(batch), extra, isinstance(item, tuple))):
                    return
        except Exception as e:  # handed to the consumer, which re-raises it
            put(e)
            return
        put(end)

    thread = threading.Thread(target=producer, daemon=True, name="device_prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            (batch, done), extra, is_tuple = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for t in batch.values():  # the allocator must not reuse them early
                    t.record_stream(stream)
            yield (batch, extra) if is_tuple else batch
    finally:
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.1)
            except Empty:
                pass
        thread.join()
