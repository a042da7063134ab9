"""Epoch-indexed metric history -> CSV.

The counterpart of `spcl_tpu/meters/storage.py` (reference
contrastyou/meters/storage_interface.py:17-84): a per-epoch dict of flattened
metric scalars appended to a history table and written to `storage.csv`
(one row per epoch, columns `group/meter/key`, written with the csv module);
`state_dict` round-trips.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List

from ..utils.utils import flatten_dict


class Storage:
    def __init__(self, save_dir: str = None, csv_name: str = "storage.csv"):
        self._save_dir = save_dir
        self._csv_name = csv_name
        self._history: Dict[int, Dict] = {}

    def put_epoch(self, epoch: int, statistics: Dict) -> None:
        self._history[int(epoch)] = flatten_dict(statistics)

    @property
    def history(self) -> Dict[int, Dict]:
        return dict(self._history)

    def columns(self) -> List[str]:
        cols: List[str] = []
        for epoch in sorted(self._history):
            cols.extend(k for k in self._history[epoch] if k not in cols)
        return cols

    def flush(self) -> None:
        if self._save_dir is None or not self._history:
            return
        Path(self._save_dir).mkdir(parents=True, exist_ok=True)
        cols = self.columns()
        with open(Path(self._save_dir) / self._csv_name, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["epoch"] + cols)
            for epoch in sorted(self._history):
                row = self._history[epoch]
                writer.writerow([epoch] + [row.get(c, "") for c in cols])

    def state_dict(self) -> Dict:
        return {"history": self._history}

    def load_state_dict(self, state: Dict) -> None:
        self._history = {int(k): v for k, v in state["history"].items()}
