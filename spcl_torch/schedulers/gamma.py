"""The self-paced age-parameter schedule (host-side, per-epoch).

`PScheduler`: gamma(t) = begin + (end-begin) * (t/T)^p (reference
semi_seg/hooks/infonce.py:34-53), a copy of `spcl_tpu/schedulers/gamma.py`'s.
Its value enters the step as a plain float. The deepclustering2 family
(Ramp/Linear/Exp/InverseExp) waits for the semi-supervised slice.
"""
from __future__ import annotations

import numpy as np


class _EpochScheduler:
    def __init__(self):
        self.epoch = 0

    def step(self):
        self.epoch += 1

    @property
    def value(self) -> float:
        return self.get_value(self.epoch)

    def get_value(self, epoch: int) -> float:
        raise NotImplementedError

    def state_dict(self):
        return {"epoch": self.epoch}

    def load_state_dict(self, state):
        self.epoch = int(state["epoch"])


class PScheduler(_EpochScheduler):
    def __init__(self, max_epoch: int, begin_value: float = 0.0, end_value: float = 1.0,
                 p: float = 0.5):
        super().__init__()
        self.max_epoch = int(max_epoch)
        self.begin_value = float(begin_value)
        self.end_value = float(end_value)
        self.p = float(p)

    def get_value(self, epoch: int) -> float:
        # clamp to [0, max_epoch]: fractional powers of a negative ratio are
        # NaN, and the trainer clock hands 0-based epochs (epoch-1) — a
        # direct _run_train_epoch() call before any start_training() would
        # otherwise poison gamma for the whole run
        frac = np.power(min(max(epoch, 0), self.max_epoch) / self.max_epoch, self.p)
        return self.begin_value + (self.end_value - self.begin_value) * float(frac)
