"""Run one cell with the program's spans traced and print what they read:

    python3 -m portbench.measure_spans --workload <cell> --seed <n> --seconds <s> \\
        [--out <file.json>]

from the root of a checkout, on a card. Set-up as `harness.run_cell`: the
data, weights and trainer from the seed, then the cell's checked and
warm-up steps' count of steps and an epoch's end, at the cell's shapes.
Then:

1. the untraced window (`harness._window`), with the caching allocator's
   counts (`spcl_torch.utils.profiling.allocator_counts`) read around it;
2. the traced stretch as `harness._traced` runs it: the traffic's
   `trace_steps` steps of a new epoch under torch.profiler, in
   `portbench.stretch` and `portbench.step`;
3. the boundary: untraced steps up to two before the end of the epoch,
   then under torch.profiler one step, and in `portbench.boundary` the
   epoch's last step and the next epoch's first (`TrainerCell.step` ends
   the one epoch and begins the next between them).

Prints one JSON line (also written to `--out`): the numbers of
`portbench/spans.py` (phases, Conv1 + Conv2, pass A, the boundary's idle,
allocations per 1,000 steps, span calls a step), `trace.reduce`'s busy and
host time of the stretch, its idle gaps named by the program's spans, the
device ms a step by UNet stage, and the host cost of one `span()` call with
the profiler off. No correctness check: `run.py` makes it.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _profiled(run, clock, tmpdir: str, name: str):
    """run() under torch.profiler (CPU, and CUDA on a card); the trace's
    events."""
    from torch.profiler import ProfilerActivity, profile
    from . import trace
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if clock.cuda else [])
    with profile(activities=acts) as prof:
        run()
        clock.sync()
    path = os.path.join(tmpdir, f"{name}.json")
    prof.export_chrome_trace(path)
    events = trace.load_events(path)
    os.unlink(path)
    return events


def _span_cost_us(clock) -> dict:
    """Host us a call of `with span(...)` with the profiler off and on (CPU,
    and CUDA on a card), and of a bare `record_function` with it off."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from spcl_torch.utils.profiling import span

    def with_span():
        with span("spcl.step"):
            pass

    def with_record_function():
        with torch.profiler.record_function("spcl.step"):
            pass

    def per_call(fn, n):
        return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6
    out = {"span_off_us": per_call(with_span, 200_000),
           "record_function_off_us": per_call(with_record_function, 20_000)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if clock.cuda else [])
    with profile(activities=acts):
        out["span_on_us"] = per_call(with_span, 2_000)
    return out


def measure(workload: str, seed: int, seconds: float, device="cuda", overrides=None) -> dict:
    """The numbers above for one run of `workload`; `device` and
    `overrides` ({"config": ..., "traffic": ...}) serve the CPU tests."""
    import importlib
    import torch
    from . import harness, manifest
    from .drivers.base import deep_merge

    harness.keep_jax_out()
    man = manifest.load()
    entry = manifest.workload(man, workload)
    overrides = overrides or {}
    config = deep_merge(manifest.config(man, entry["config"]), overrides.get("config", {}))
    traffic = deep_merge(manifest.traffic(entry["traffic"]), overrides.get("traffic", {}))
    driver = importlib.import_module(f"portbench.drivers.{config['driver']}")
    clock = harness.Clock(device)
    tmpdir = tempfile.mkdtemp(prefix="portbench_spans_")
    try:
        cell = driver.Cell(config, traffic, seed, device, os.path.join(tmpdir, "run"))
        out = {"workload": workload, "seed": seed,
               "device": torch.cuda.get_device_name(0) if clock.cuda else "cpu",
               **_span_cost_us(clock)}
        out.update(_measure_cell(cell, traffic, seconds, device, clock, tmpdir))
        cell.close()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def _measure_cell(cell, traffic, seconds, device, clock, tmpdir) -> dict:
    from torch.profiler import record_function
    from . import harness, spans, trace
    from spcl_torch.utils.profiling import allocator_counts

    for _ in range(int(traffic["check_steps"]) + int(traffic["warmup_steps"])):
        cell.step()
    cell.end_epoch()
    clock.sync()
    out = {}
    before = allocator_counts()
    win = harness._window(cell, seconds, device)
    after = allocator_counts()
    out.update({"window_steps": win["steps"], "samples_per_s": win["views"] / win["window_s"],
                "alloc.device_allocs_per_1k_steps":
                    spans.allocs_per_1k_steps(before, after, win["steps"]),
                "allocator": {k: after[k] - before[k] for k in after}})

    steps = int(traffic["trace_steps"])
    if cell.epoch_open:
        cell.end_epoch()

    def stretch():
        cell.step()
        clock.sync()
        with record_function("portbench.stretch"):
            for _ in range(steps):
                with record_function("portbench.step"):
                    cell.step()
            clock.sync()
    events = _profiled(stretch, clock, tmpdir, "stretch")
    red = trace.reduce(events)
    out.update(spans.step_metrics(events, steps))
    out.update({"trace_steps": steps, "launches_per_step": red["launches"] / steps,
                "device.idle_pct": (100.0 * (1.0 - red["busy_us"] / red["span_us"])
                                    if red["busy_us"] else None),
                "busy_ms_per_step": red["busy_us"] / 1e3 / steps,
                "host_ms_per_step": red["span_us"] / 1e3 / steps,
                "span_calls_per_step": spans.span_calls(events, steps),
                "stage_ms": spans.stage_ms(events, steps),
                "idle_gaps": spans.idle_gaps(events)})
    del events

    # one step before the epoch's last, which starts the profiler's machinery
    # outside the boundary's span
    target = cell.num_batches - 2
    if target <= 0 and cell.epoch_open:
        cell.end_epoch()
    while target > 0 and not (cell.epoch_open and cell.epoch_steps == target):
        cell.step()

    def boundary():
        cell.step()
        clock.sync()
        with record_function("portbench.boundary"):
            cell.step()
            cell.step()
            clock.sync()
    t0 = time.perf_counter()
    events = _profiled(boundary, clock, tmpdir, "boundary")
    idle = spans.boundary_idle(events, "portbench.boundary")
    lo, hi = spans._window(events, "portbench.boundary")
    out.update({"epoch.boundary_idle_ms": None if idle is None else idle["total"],
                "boundary_idle_by_span_ms": idle, "boundary_ms": (hi - lo) / 1e3,
                "boundary_idle_gaps": spans.idle_gaps(events),
                "boundary_wall_s": time.perf_counter() - t0, "failed": cell.failed})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import _fixed_caches
    _fixed_caches()
    result = measure(args.workload, args.seed, args.seconds)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
