"""Per-epoch schedules (host-side), copies of `spcl_tpu/schedulers/gamma.py`'s:

- `PScheduler`: gamma(t) = begin + (end-begin) * (t/T)^p, the self-paced age
  schedule (reference semi_seg/hooks/infonce.py:34-53);
- `RampScheduler`: the deepclustering2 sigmoid-style ramp, UC-MT's threshold;
- `LinearScheduler`, `ExpScheduler`, `InverseExpScheduler`: the rest of the
  deepclustering2 scheduler family, each clamped at `max_epoch`.

Their values enter the step as plain floats.
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


class RampScheduler(_EpochScheduler):
    """Ramp between the begin and max epochs, flat after them."""

    def __init__(self, begin_epoch: int, max_epoch: int, min_value: float, max_value: float,
                 ramp_mult: float = -5.0):
        super().__init__()
        self.begin_epoch = int(begin_epoch)
        self.max_epoch = int(max_epoch)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.ramp_mult = float(ramp_mult)

    def get_value(self, epoch: int) -> float:
        if epoch < self.begin_epoch:
            return self.min_value
        if epoch >= self.max_epoch:
            return self.max_value
        frac = (epoch - self.begin_epoch) / max(self.max_epoch - self.begin_epoch, 1)
        # sigmoid-style ramp (deepclustering2 convention)
        return self.min_value + (self.max_value - self.min_value) * float(
            np.exp(self.ramp_mult * (1.0 - frac) ** 2))


class LinearScheduler(_EpochScheduler):
    def __init__(self, max_epoch: int, begin_value: float, end_value: float):
        super().__init__()
        self.max_epoch = int(max_epoch)
        self.begin_value = float(begin_value)
        self.end_value = float(end_value)

    def get_value(self, epoch: int) -> float:
        frac = min(epoch / self.max_epoch, 1.0)
        return self.begin_value + (self.end_value - self.begin_value) * frac


class ExpScheduler(_EpochScheduler):
    def __init__(self, max_epoch: int, begin_value: float, end_value: float, p: float = 5.0):
        super().__init__()
        self.max_epoch = int(max_epoch)
        self.begin_value = float(begin_value)
        self.end_value = float(end_value)
        self.p = float(p)

    def get_value(self, epoch: int) -> float:
        frac = min(epoch / self.max_epoch, 1.0)
        w = (np.exp(self.p * frac) - 1.0) / (np.exp(self.p) - 1.0)
        return self.begin_value + (self.end_value - self.begin_value) * float(w)


class InverseExpScheduler(_EpochScheduler):
    def __init__(self, max_epoch: int, begin_value: float, end_value: float, p: float = 5.0):
        super().__init__()
        self.max_epoch = int(max_epoch)
        self.begin_value = float(begin_value)
        self.end_value = float(end_value)
        self.p = float(p)

    def get_value(self, epoch: int) -> float:
        frac = min(epoch / self.max_epoch, 1.0)
        w = 1.0 - (np.exp(self.p * (1 - frac)) - 1.0) / (np.exp(self.p) - 1.0)
        return self.begin_value + (self.end_value - self.begin_value) * float(w)
