"""TensorBoard writer: the counterpart of `spcl_tpu/writer.py` (reference
contrastyou/writer.py:20-72).

`SummaryWriter` flattens a nested metric tree to scalar tags (`tra/sup_loss/
mean`, ...) and skips values that are not numbers or are NaN;
`add_matrix_image` writes a [N, N] matrix (the contrastive diagnostics of
`Trainer.dump_matrices`) as a grayscale image scaled to [0, 1]. It writes
through `torch.utils.tensorboard`, which needs the `tensorboard` package;
without it the writer is a no-op and says so once in the log. `NullWriter`
has the same interface and writes nothing (ranks other than 0).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from .utils.utils import flatten_dict, get_logger

logger = get_logger("writer")
_warned = False


def _tensorboard_writer(log_dir: str):
    """torch.utils.tensorboard's writer on `log_dir`, or None (logged once)
    when tensorboard does not import."""
    global _warned
    try:
        from torch.utils.tensorboard import SummaryWriter as _TBWriter
    except Exception as e:  # tensorboard is not installed
        if not _warned:
            logger.info("tensorboard unavailable (%s): TensorBoard events are off", e)
            _warned = True
        return None
    return _TBWriter(log_dir=log_dir)


class SummaryWriter:
    def __init__(self, log_dir: str):
        self._log_dir = log_dir
        self._tb = _tensorboard_writer(log_dir)

    def add_scalars_from_meter_interface(self, epoch: int, **group_stats: Dict) -> None:
        if self._tb is None:
            return
        for tag, value in flatten_dict(group_stats).items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            if math.isnan(v):
                continue
            self._tb.add_scalar(tag, v, global_step=epoch)

    def add_matrix_image(self, tag: str, matrix, epoch: int) -> None:
        """A [N, N] matrix as a grayscale image, min..max scaled to [0, 1]."""
        if self._tb is None:
            return
        m = np.asarray(matrix, dtype=np.float32)
        lo, hi = np.nanmin(m), np.nanmax(m)
        self._tb.add_image(tag, ((m - lo) / (hi - lo + 1e-12))[None, :, :], global_step=epoch)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


class NullWriter(SummaryWriter):
    """The writer of a rank other than 0: the same interface, no IO."""

    def __init__(self):
        self._log_dir = None
        self._tb = None
