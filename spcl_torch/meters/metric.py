"""Metric base class.

Capability parity with reference contrastyou/meters/metric.py:14-73. The
reference optionally drains `add` calls on a worker thread; here the same
option exists for expensive host-side metrics (surface distances), while
cheap meters stay synchronous. Device tensors should be converted by the
caller (one bulk copy to the host per epoch) before `add`.
"""
from __future__ import annotations

import queue
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict


class _StopToken:
    pass


class Metric(ABC):
    def empty(self) -> bool:
        """True when no observation was ever added (skipped by statistics)."""
        return False

    def __init__(self, threaded: bool = False):
        self._threaded = threaded
        self._queue: "queue.Queue" = None
        self._worker: threading.Thread = None
        if threaded:
            self._start_worker()

    def _start_worker(self):
        self._queue = queue.Queue()

        def drain():
            while True:
                item = self._queue.get()
                if isinstance(item, _StopToken):
                    break
                args, kwargs = item
                self._add(*args, **kwargs)

        self._worker = threading.Thread(target=drain, daemon=True)
        self._worker.start()

    def add(self, *args, **kwargs):
        if self._threaded:
            self._queue.put((args, kwargs))
        else:
            self._add(*args, **kwargs)

    def join(self):
        if self._threaded and self._worker is not None:
            self._queue.put(_StopToken())
            self._worker.join()
            self._start_worker()

    def summary(self) -> Dict[str, Any]:
        self.join()
        return self._summary()

    @abstractmethod
    def reset(self): ...

    @abstractmethod
    def _add(self, *args, **kwargs): ...

    @abstractmethod
    def _summary(self) -> Dict[str, Any]: ...
