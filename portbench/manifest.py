"""`BENCHMARK.json` and the files it names, found by name.

A cell is its entry under `workloads`: a configuration
(`configs/<config>.json`, the file its `configs` entry names), a traffic mix
(`traffic/<traffic>.json`) and the limits of its correctness check
(`limits/<cell>.json`). A metric is its entry under `end_to_end` or
`per_layer` and its reader, `metrics/<name>.py`.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def workload(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _json(Path(root) / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> Dict:
    return _json(HERE / "limits" / f"{cell}.json")


def metrics(manifest: Dict, cell: str, traced: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with `workloads` only in those."""
    group = manifest["per_layer"] if traced else manifest["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"
