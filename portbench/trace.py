"""Reduction of a torch.profiler chrome trace to what the per-layer metrics
read.

Device time is spcl_torch's definition (`utils/profiling.py`, frozen here):
the device events of CUDA kernels, memory copies and memory sets, never the
device-side ranges of user annotations. Busy time is the union of those
events' intervals; a launch is one kernel event. An idle gap is named by
what the host was doing at its middle: the innermost benchmark span and the
innermost host operation that cover it. The traced window is the extent of
the benchmark's spans; device events that start in it are counted.
"""
from __future__ import annotations

import gzip
import json
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def load_events(path: str) -> List[dict]:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]


def _union(intervals: List[Tuple[float, float]]):
    """Merged (start, end) intervals, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: List[dict], span_prefix: str = "portbench.", top: int = 10) -> Dict:
    """{"kernels": [(name, us)], "launches": n, "busy_us", "span_us",
    "device_ops": [(name, s)] top first, "idle_gaps": [(name, s)] longest
    first}."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(span_prefix)]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES
            and not str(e.get("name", "")).startswith(span_prefix)]
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if spans:
        lo = min(float(e["ts"]) for e in spans)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
        dev = [e for e in dev if lo <= float(e["ts"]) < hi]
    else:
        lo = min((float(e["ts"]) for e in dev), default=0.0)
        hi = max((float(e["ts"]) + float(e.get("dur", 0)) for e in dev), default=0.0)
    spans_dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev]
    merged = _union([(max(a, lo), min(b, hi)) for a, b in spans_dev if a < hi and b > lo])
    busy = sum(b - a for a, b in merged)
    totals: Dict[str, float] = {}
    for e in dev:
        totals[e["name"]] = totals.get(e["name"], 0.0) + float(e.get("dur", 0)) / 1e6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    if merged:
        gaps = [(lo, merged[0][0])] + gaps + [(merged[-1][1], hi)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]

    def doing(t: float) -> str:
        outer = [e for e in spans if e["ts"] <= t <= e["ts"] + e["dur"]]
        inner = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
        name = max(outer, key=lambda e: e["ts"])["name"] if outer else "outside the spans"
        if inner:
            name += " > " + max(inner, key=lambda e: e["ts"])["name"]
        return name

    return {"kernels": [(e["name"], float(e.get("dur", 0))) for e in dev
                        if e.get("cat") == "kernel"],
            "launches": sum(1 for e in dev if e.get("cat") == "kernel"),
            "busy_us": busy, "span_us": hi - lo,
            "device_ops": sorted(totals.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": [(doing((a + b) / 2), (b - a) / 1e6) for a, b in gaps]}
