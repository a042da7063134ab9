"""Named meters in focus groups.

Capability parity with reference contrastyou/meters/meter_interface.py:8-103:
meters registered under group names ("tra"/"eval"/per-hook), a `focus_on`
contextmanager for hooks to namespace their meters, `statistics()` skipping
underscore-prefixed groups.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

from .metric import Metric


class MeterInterface:
    def __init__(self, default_focus: str = "tra"):
        self._groups: Dict[str, Dict[str, Metric]] = {}
        self._focus = default_focus

    @property
    def focus(self) -> str:
        return self._focus

    @contextmanager
    def focus_on(self, group: str):
        prev = self._focus
        self._focus = group
        try:
            yield self
        finally:
            self._focus = prev

    def register_meter(self, name: str, meter: Metric) -> Metric:
        self._groups.setdefault(self._focus, {})[name] = meter
        return meter

    def delete_meter(self, name: str) -> None:
        self._groups.get(self._focus, {}).pop(name, None)

    def __getitem__(self, name: str) -> Metric:
        return self._groups[self._focus][name]

    def __contains__(self, name: str) -> bool:
        return name in self._groups.get(self._focus, {})

    def get_meter(self, name: str, group: str = None) -> Metric:
        return self._groups[group or self._focus][name]

    def reset(self) -> None:
        for group in self._groups.values():
            for meter in group.values():
                meter.reset()

    def join(self) -> None:
        for group in self._groups.values():
            for meter in group.values():
                meter.join()

    def statistics(self, group: str = None) -> Dict[str, Dict]:
        """{group: {meter: summary}} — hides `_`-prefixed groups unless asked."""
        if group is not None:
            return {name: meter.summary()
                    for name, meter in self._groups.get(group, {}).items()
                    if not meter.empty()}
        out = {}
        for gname, meters in self._groups.items():
            if gname.startswith("_"):
                continue
            out[gname] = {name: meter.summary() for name, meter in meters.items()
                          if not meter.empty()}
        return out
