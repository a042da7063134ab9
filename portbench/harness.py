"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, the result line.

Set-up (counted in `setup_s`, from the process's start): imports, the
benchmark's data and weights from the seed, the trainer and its kernels,
the checked steps (the benchmark's own batches and draws through the
window's call), two more steps and an epoch's end, all at the cell's own
shapes. The window then runs whole steps back to back from a new epoch and
ends at the first step boundary after `--seconds`; a CUDA event marks every
step boundary on the stream, with no host synchronisation inside the window
but the epochs' own drains. With `--trace 1` the traffic's `trace_steps`
steps of a new epoch after the window run under torch.profiler, in the
benchmark's spans: a fixed stretch with no epoch end in it, so that its
launch count repeats.

After the window the program is freed and the reference follows the
checked steps from the same weights, batches and draws; `compare.py` holds
the program to it.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import types
from typing import Dict, List, Optional

from . import compare, manifest
from .drivers.base import deep_merge
from .peaks import H100

FORBIDDEN = ("jax", "jaxlib", "flax", "spcl_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (`spcl_torch` is not `spcl_tpu`)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def refuse_jax(err) -> None:
    """Exit 3, naming them, where JAX or the JAX package was loaded."""
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the run may not import JAX "
              "or the JAX package", file=err)
        raise SystemExit(3)


def keep_jax_out() -> None:
    """TensorBoard, which the program's writer uses where it is installed,
    imports TensorFlow, and TensorFlow imports JAX where that is installed.
    TensorBoard's own switch (`tensorboard.compat.notf`) makes it take its
    TensorFlow stub instead; it writes the same event files."""
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  manifest.metric_file(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Clock:
    """Step boundaries: CUDA events on the stream on a card, the host clock
    elsewhere (the CPU tests)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_s(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def _window(cell, seconds: float, device) -> Dict:
    import torch
    clock = Clock(device)
    clock.sync()
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clock.mark()
    steps = views = 0
    while True:
        views += cell.step()
        steps += 1
        clock.mark()
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    t1 = time.perf_counter()
    return {"window_s": t1 - t0, "steps": steps, "views": views,
            "step_s": clock.intervals_s(),
            "peak_bytes": torch.cuda.max_memory_allocated() if clock.cuda else None}


def _traced(cell, steps: int, device, tmpdir: str) -> Dict:
    """`steps` steps of a new epoch under torch.profiler, after one step that
    starts the profiler's own machinery outside the benchmark's spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import trace
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    clock = Clock(device)
    if cell.epoch_open:
        cell.end_epoch()
    clock.sync()
    with profile(activities=acts) as prof:
        cell.step()
        clock.sync()
        with record_function("portbench.stretch"):
            for _ in range(steps):
                with record_function("portbench.step"):
                    cell.step()
            clock.sync()
    path = os.path.join(tmpdir, "portbench_trace.json")
    prof.export_chrome_trace(path)
    out = trace.reduce(trace.load_events(path))
    os.unlink(path)
    out["steps"] = steps
    return out


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *, device="cuda",
             t_start: Optional[float] = None, overrides: Optional[Dict] = None,
             fault: Optional[str] = None, out=None, err=None) -> Dict:
    """Run `workload` once; print the checks to `err` and the result line to
    `out`; return the result. `overrides` ({"config": ..., "traffic": ...})
    and `fault` serve the CPU tests."""
    keep_jax_out()
    import torch
    out, err = out or sys.stdout, err or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest.load()
    entry = manifest.workload(man, workload)
    config = manifest.config(man, entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    overrides = overrides or {}
    config = deep_merge(config, overrides.get("config", {}))
    traffic = deep_merge(traffic, overrides.get("traffic", {}))
    limits = manifest.limits(workload)
    driver = importlib.import_module(f"portbench.drivers.{config['driver']}")
    counts = importlib.import_module(f"portbench.counts.{config['counts']}")
    reference = importlib.import_module(f"portbench.reference.{config['reference']}")

    on_card = torch.device(device).type == "cuda"
    tmpdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        marks = [("imports", time.perf_counter())]
        cell = driver.Cell(config, traffic, seed, device, os.path.join(tmpdir, "run"),
                           fault=fault)
        marks.append(("data and trainer", time.perf_counter()))
        checked = cell.run_checked(int(traffic["check_steps"]))
        marks.append(("checked steps", time.perf_counter()))
        for _ in range(int(traffic["warmup_steps"])):
            cell.step()
        cell.end_epoch()
        Clock(device).sync()
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        print("setup " + " ".join(f"{name}: {t - prev:.3f} s" for (name, t), prev in
                                  zip(marks, [t_start] + [t for _, t in marks])), file=err)
        setup_peak = torch.cuda.max_memory_allocated() if on_card else 0

        win = _window(cell, seconds, device)
        ctx = {"setup_s": setup_s, **win,
               "flops_per_step": counts.flops_per_step(config, cell.program),
               "stage_bound_s": counts.stage_bound_s_per_step(config, cell.program),
               "peaks": H100}
        if traced:
            ctx["trace"] = _traced(cell, int(traffic["trace_steps"]), device, tmpdir)
        if cell.epoch_open:
            cell.end_epoch()
        attempted = len(checked["losses"]) + int(traffic["warmup_steps"]) + win["steps"] + (
            ctx["trace"]["steps"] + 1 if traced else 0)
        failed = cell.failed
        refuse_jax(err)
        inputs = cell.reference_inputs()
        program = cell.program
        cell.close()
        del cell
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        ref = reference.follow(inputs, checked["feeds"], config, program,
                               int(traffic["window_epoch"]), "float32", device)
        values = compare.gaps(checked, ref, inputs["weights"])
        correct, checks = compare.judge(values, limits)
        correct = correct and failed == 0

        metrics = {}
        for m in manifest.metrics(man, workload, traced):
            value = _reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
               "count": int(entry["chips"]),
               "memory_peak_bytes": int(max(setup_peak, win["peak_bytes"] or 0))}
        result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": dev}
        if traced:
            tr = ctx["trace"]
            dev["busy_s"] = tr["busy_us"] / 1e6
            dev["window_s"] = tr["span_us"] / 1e6
            result["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                                   "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
        result["checks"] = checks
        refuse_jax(err)
        for k, c in checks.items():
            print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
        print(json.dumps(result), file=out)
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
