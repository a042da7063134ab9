"""Running-average meters (reference contrastyou/meters/averagemeter.py:9-75)."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .metric import Metric


class AverageValueMeter(Metric):
    def __init__(self):
        super().__init__(threaded=False)
        self.reset()

    def reset(self):
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0

    def _add(self, value, n: int = 1):
        value = float(value)
        for _ in range(int(n)):
            self._n += 1
            delta = value - self._mean
            self._mean += delta / self._n
            self._m2 += delta * (value - self._mean)

    @property
    def mean(self) -> float:
        return self._mean if self._n else float("nan")

    def empty(self) -> bool:
        return self._n == 0

    @property
    def std(self) -> float:
        if self._n < 2:
            return float("nan")
        return math.sqrt(self._m2 / (self._n - 1))

    def _summary(self) -> Dict[str, float]:
        return {"mean": self.mean}


class MultipleAverageValueMeter(Metric):
    """Keyed average meters: add(a=1.0, b=2.0)."""

    def __init__(self):
        super().__init__(threaded=False)
        self.reset()

    def reset(self):
        self._meters: Dict[str, AverageValueMeter] = {}

    def _add(self, **kwargs):
        for k, v in kwargs.items():
            self._meters.setdefault(k, AverageValueMeter()).add(v)

    def _summary(self) -> Dict[str, float]:
        return {k: m.mean for k, m in self._meters.items()}


class AverageValueListMeter(Metric):
    """Positional list-of-averages (e.g. per-LR-group learning rates)."""

    def __init__(self):
        super().__init__(threaded=False)
        self.reset()

    def reset(self):
        self._meters: List[AverageValueMeter] = []

    def _add(self, values):
        if np.isscalar(values):
            values = [values]
        while len(self._meters) < len(values):
            self._meters.append(AverageValueMeter())
        for m, v in zip(self._meters, values):
            m.add(float(v))

    def _summary(self) -> Dict[str, float]:
        if len(self._meters) == 1:
            return {"mean": self._meters[0].mean}
        return {f"lr_{i}": m.mean for i, m in enumerate(self._meters)}
