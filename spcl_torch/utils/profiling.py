"""Device time and the program's spans under `torch.profiler`: the
counterpart of `spcl_tpu/utils/profiling.py` (which reads jax.profiler's
device plane).

One definition of what counts as device time, shared by `Trainer.profile_dir`
and `chip_smoke.py`: the device events of CUDA kernels, memory copies and
memory sets, never the device-side ranges of user annotations (they span
kernels that are counted already).

- `span(name)`: a `record_function` range while the torch profiler runs, a
  shared null context otherwise (a flag test, no profiler call). The
  program's spans (`spcl.step.*`, `spcl.unet.*`, `spcl.gradcache.*`,
  `spcl.epoch.*`) appear exactly when something profiles, on the clock of
  the kernels they launch.
- `allocator_counts()`: the caching allocator's own counts of device
  allocations and of retries after freeing its cache.
- `GRAPH_COUNTS`: how often the train steps engaged a CUDA graph
  (`training/steps.py::GraphedStep`): captures and replays, plain integers
  since the process started or `reset_graph_counts()`.
- `launch_counts(names)`: a kernel module's `LAUNCHES` ({kernel: launches}),
  registered in `LAUNCH_COUNTERS`, whose counts a graph replay advances by
  the launches its capture counted.
- `kernel_times(run, steps)`: run(steps) under the profiler (CPU + CUDA
  activities) -> {event name: (ms per step, launches per step)}.
- `device_ms_per_step(trace_dir, calls)`: the device ms per call of a chrome
  trace that the profiler exported into `trace_dir` (`export_chrome_trace`),
  summed over every `*.json` file there; None for a trace that holds no
  device event, as a CPU trace does.
- `trace(run, trace_dir)`: run() under the profiler, its chrome trace
  written to `trace_dir`.
"""
from __future__ import annotations

import contextlib
import gzip
import json
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

# chrome-trace categories of device work (torch.profiler / kineto)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


# what `span` hands out while nothing profiles: one context, built once
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`with span("spcl.step.forward"): ...`: a `record_function` range named
    `name` while the torch profiler is on, else a shared null context.
    `record_function` costs microseconds a call even with the profiler off;
    the flag test costs a module attribute read."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def allocator_counts(device=None) -> Dict[str, int]:
    """{"device_allocs", "alloc_retries"}: the caching allocator's counts of
    cudaMalloc calls and of allocations retried after it freed its cache,
    since the process started (`torch.cuda.memory_stats`); zeros without a
    card."""
    if not torch.cuda.is_available():
        return {"device_allocs": 0, "alloc_retries": 0}
    stats = torch.cuda.memory_stats(device)
    return {"device_allocs": int(stats.get("num_device_alloc", 0)),
            "alloc_retries": int(stats.get("num_alloc_retries", 0))}


GRAPH_COUNTS: Dict[str, int] = {"captures": 0, "replays": 0}


def reset_graph_counts() -> None:
    for k in GRAPH_COUNTS:
        GRAPH_COUNTS[k] = 0


# every kernel module's launch counts, in the order the modules were imported
LAUNCH_COUNTERS: List[Dict[str, int]] = []


def launch_counts(names: Iterable[str]) -> Dict[str, int]:
    """{name: 0} for each kernel, registered in `LAUNCH_COUNTERS`: a module's
    wrappers add one at each launch, and a CUDA graph replay adds the
    launches its capture counted, so that the counts hold every launch,
    replayed or not."""
    counts = {name: 0 for name in names}
    LAUNCH_COUNTERS.append(counts)
    return counts


def activities():
    """CPU, and CUDA where the card is there."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def kernel_times(run: Callable[[int], object], steps: int) -> Dict[str, Tuple[float, int]]:
    """{event name: (ms per step, launches per step)} of the device events of
    run(steps) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    with profile(activities=activities()) as prof:
        run(steps)
        _sync()
    out = {}
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms = float(getattr(e, "self_device_time_total", 0.0)
                       or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / steps
            out[e.key] = (ms, e.count // steps)
    return out


def _device_events(trace_dir: str) -> Iterator[dict]:
    for path in sorted(Path(trace_dir).rglob("*.json*")):
        opener = gzip.open if path.suffix == ".gz" else open
        try:
            with opener(path, "rt") as f:
                events = json.load(f).get("traceEvents", [])
        except (OSError, ValueError):
            continue
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
                yield e


def device_ms_per_step(trace_dir: str, calls: Optional[int] = None) -> Optional[float]:
    """Device ms per call (per step) of the chrome traces in `trace_dir`:
    the summed duration of their device events over `calls` (1 if None);
    None when there is no device event."""
    total_us, seen = 0.0, False
    for e in _device_events(trace_dir):
        total_us += float(e.get("dur", 0.0))
        seen = True
    if not seen:
        return None
    return total_us / 1e3 / max(int(calls or 1), 1)


def trace(run: Callable[[], object], trace_dir: str) -> None:
    """run() under torch.profiler (CPU + CUDA activities), its chrome trace
    written to trace_dir/trace.json."""
    from torch.profiler import profile
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities()) as prof:
        run()
        _sync()
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
