"""The program's spans in a torch.profiler chrome trace: device time by
phase of the train step and by UNet stage, the device's idle at an epoch
boundary, and idle gaps named by the innermost span.

`spcl_torch` opens its spans (`utils/profiling.py::span`) only while the
profiler runs: `spcl.step` and its phases `spcl.step.<phase>`,
`spcl.unet.<stage>`, `spcl.gradcache.pass_a`, `spcl.epoch.<part>`. A trace
of a program without them reads None for every number here.

Device events are `trace.DEVICE_CATEGORIES` (kernels, copies, sets) that
start inside the window: the extent of the named benchmark span. Each
belongs to the host call that launched it, the `cuda_runtime` or
`cuda_driver` event with the same `args.correlation`.
- Its phase is the innermost `spcl.step*` span open at the launch, on the
  launching thread, else on any thread: a backward launched from the
  autograd engine's thread falls in the step thread's `spcl.step.backward`.
- Its stage is the innermost `spcl.unet.*` span around the launch on its
  thread; a launch inside a backward node
  (`autograd::engine::evaluate_function: ...`) takes the stage of the
  forward op that made the node, the op with the node's `Sequence number`.
An event counts the part of its interval, clipped to the window, that no
earlier-starting event covers, so overlapping events count each instant
once: the phases and the unattributed share add up to `trace.reduce`'s
busy time exactly.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .trace import DEVICE_CATEGORIES, HOST_CATEGORIES, _union

BACKWARD_NODE = "autograd::engine::evaluate_function"
PHASES = ("input", "forward", "teacher", "loss", "backward", "optimizer", "ema")
CONV12 = ("spcl.unet.Conv1", "spcl.unet.Conv2")
PASS_A = "spcl.gradcache.pass_a"
ANY_THREAD = "any"


def _is(family: str, name: str) -> bool:
    return name == family or name.startswith(family + ".")


def _window(events: List[dict], window: str) -> Tuple[float, float]:
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == window]
    if not spans:
        raise ValueError(f"no {window!r} span in the trace")
    return (min(float(e["ts"]) for e in spans),
            max(float(e["ts"]) + float(e["dur"]) for e in spans))


def _device(events: List[dict], lo: float, hi: float) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES
            and lo <= float(e["ts"]) < hi]


def _innermost(spans: Iterable[dict], queries: List[Tuple[object, float, int]],
               thread_of=lambda e: e.get("tid")) -> Dict[int, Optional[dict]]:
    """{query key: the innermost span open at its time on its thread, or
    None} for queries (thread, time, key). Spans of one thread nest."""
    by_thread: Dict[object, List[dict]] = {}
    for e in spans:
        by_thread.setdefault(thread_of(e), []).append(e)
    for v in by_thread.values():
        v.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    out: Dict[int, Optional[dict]] = {}
    for thread in {q[0] for q in queries}:
        todo = sorted((q for q in queries if q[0] == thread), key=lambda q: q[1])
        spans_here, i, stack = by_thread.get(thread, []), 0, []
        for _, t, key in todo:
            while i < len(spans_here) and float(spans_here[i]["ts"]) <= t:
                start = float(spans_here[i]["ts"])
                while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) < start:
                    stack.pop()
                stack.append(spans_here[i])
                i += 1
            while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) < t:
                stack.pop()
            out[key] = stack[-1] if stack else None
    return out


def _busy(dev: List[dict], lo: float, hi: float) -> List[float]:
    """Each event's us of the busy time: its interval clipped to [lo, hi)
    less what events that started before it already cover."""
    out, covered = [0.0] * len(dev), lo
    for i in sorted(range(len(dev)), key=lambda i: float(dev[i]["ts"])):
        a = max(float(dev[i]["ts"]), covered)
        b = min(float(dev[i]["ts"]) + float(dev[i].get("dur", 0.0)), hi)
        out[i] = max(b - a, 0.0)
        covered = max(covered, b)
    return out


def attribute(events: List[dict], window: str = "portbench.stretch") -> List[Dict]:
    """[{"dur": busy us, "phase": name or None, "stage": name or None,
    "pass_a": bool}] for each device event in the window."""
    lo, hi = _window(events, window)
    dev = _device(events, lo, hi)
    busy = _busy(dev, lo, hi)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    phase_spans = [e for e in notes if _is("spcl.step", e["name"])]
    stage_spans = [e for e in notes if _is("spcl.unet", e["name"])]
    pass_spans = [e for e in notes if e["name"] == PASS_A]
    nodes = [e for e in events if e.get("cat") == "cpu_op"
             and str(e["name"]).startswith(BACKWARD_NODE)]
    seq_ops = [e for e in events if e.get("cat") == "cpu_op"
               and "Sequence number" in e.get("args", {})
               and not str(e["name"]).startswith(BACKWARD_NODE)]

    # the forward ops: ops with a sequence number outside every backward node
    in_node = _innermost(nodes, [(e.get("tid"), float(e["ts"]), i)
                                 for i, e in enumerate(seq_ops)])
    forward = [e for i, e in enumerate(seq_ops) if in_node[i] is None]
    op_stage = _innermost(stage_spans, [(e.get("tid"), float(e["ts"]), i)
                                        for i, e in enumerate(forward)])
    stage_of_seq: Dict[int, Optional[str]] = {}
    for i, e in enumerate(forward):
        stage_of_seq.setdefault(e["args"]["Sequence number"],
                                op_stage[i]["name"] if op_stage[i] else None)

    launch = [launches.get(e.get("args", {}).get("correlation")) for e in dev]
    here = [(h.get("tid"), float(h["ts"]), i) for i, h in enumerate(launch) if h is not None]
    anywhere = [(ANY_THREAD, t, i) for _, t, i in here]
    any_thread = lambda e: ANY_THREAD  # noqa: E731
    phase = _innermost(phase_spans, here)
    phase_any = _innermost(phase_spans, anywhere, any_thread)
    stage = _innermost(stage_spans, here)
    node = _innermost(nodes, here)
    pass_a = _innermost(pass_spans, anywhere, any_thread)

    out = []
    for i, e in enumerate(dev):
        row = {"dur": busy[i], "phase": None, "stage": None, "pass_a": False}
        if launch[i] is not None:
            p = phase.get(i) or phase_any.get(i)
            row["phase"] = p["name"] if p else None
            if node.get(i) is not None:
                row["stage"] = stage_of_seq.get(node[i]["args"].get("Sequence number"))
            elif stage.get(i) is not None:
                row["stage"] = stage[i]["name"]
            row["pass_a"] = pass_a.get(i) is not None
        out.append(row)
    return out


def step_metrics(events: List[dict], steps: int,
                 window: str = "portbench.stretch") -> Dict[str, Optional[float]]:
    """The per-layer numbers of a stretch of `steps` steps: `phase.<p>_ms`
    (busy device ms a step launched under `spcl.step.<p>`), `phase.
    unattributed_pct` (the share of the busy time launched under none of
    them), `unet.conv12_ms` (Conv1 and Conv2, forward and backward, student
    and teacher) and `gradcache.pass_a_ms`; None where the span never
    opened in the window."""
    lo, hi = _window(events, window)
    opened = {e["name"] for e in events if e.get("cat") == "user_annotation"
              and str(e["name"]).startswith("spcl.")
              and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo}
    rows = attribute(events, window)
    total = sum(r["dur"] for r in rows)
    out: Dict[str, Optional[float]] = {}
    for p in PHASES:
        name = f"spcl.step.{p}"
        out[f"phase.{p}_ms"] = (sum(r["dur"] for r in rows if r["phase"] == name) / 1e3 / steps
                                if name in opened else None)
    named = sum(r["dur"] for r in rows if r["phase"] in {f"spcl.step.{p}" for p in PHASES})
    out["phase.unattributed_pct"] = (100.0 * (total - named) / total
                                     if total and "spcl.step" in opened else None)
    out["unet.conv12_ms"] = (sum(r["dur"] for r in rows if r["stage"] in CONV12) / 1e3 / steps
                             if opened & set(CONV12) else None)
    out["gradcache.pass_a_ms"] = (sum(r["dur"] for r in rows if r["pass_a"]) / 1e3 / steps
                                  if PASS_A in opened else None)
    return out


def stage_ms(events: List[dict], steps: int,
             window: str = "portbench.stretch") -> Dict[str, float]:
    """{stage span (or "none"): device ms a step}, largest first."""
    totals: Dict[str, float] = {}
    for r in attribute(events, window):
        key = r["stage"] or "none"
        totals[key] = totals.get(key, 0.0) + r["dur"] / 1e3 / steps
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def _gaps(events: List[dict], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The device's idle intervals in [lo, hi), as `trace.reduce` finds them."""
    merged = _union([(max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0)), hi))
                     for e in _device(events, lo, hi)])
    if not merged:
        return [(lo, hi)]
    gaps = [(lo, merged[0][0])] + [(merged[i][1], merged[i + 1][0])
                                   for i in range(len(merged) - 1)] + [(merged[-1][1], hi)]
    return [g for g in gaps if g[1] > g[0]]


def boundary_idle(events: List[dict],
                  window: str = "portbench.boundary") -> Optional[Dict[str, float]]:
    """{`spcl.epoch.<part>`: device idle ms whose gap's middle falls under
    that span (the innermost, on any thread)} in the window, with their sum
    under "total"; None where no epoch span opened there."""
    lo, hi = _window(events, window)
    epoch = [e for e in events if e.get("cat") == "user_annotation"
             and _is("spcl.epoch", e["name"])
             and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    if not epoch:
        return None
    gaps = _gaps(events, lo, hi)
    under = _innermost(epoch, [(ANY_THREAD, (a + b) / 2, i) for i, (a, b) in enumerate(gaps)],
                       lambda e: ANY_THREAD)
    out = {"total": 0.0}
    for i, (a, b) in enumerate(gaps):
        if under[i] is not None:
            out[under[i]["name"]] = out.get(under[i]["name"], 0.0) + (b - a) / 1e3
            out["total"] += (b - a) / 1e3
    return out


def idle_gaps(events: List[dict], span_prefix: str = "portbench.",
              top: int = 10) -> List[Tuple[str, float]]:
    """`trace.reduce`'s idle gaps, named by the innermost benchmark span, the
    innermost `spcl.` span and the innermost host operation at the gap's
    middle: "portbench.step > spcl.step.backward > aten::empty"."""
    bench = [e for e in events if e.get("cat") == "user_annotation"
             and str(e["name"]).startswith(span_prefix)]
    lo = min(float(e["ts"]) for e in bench)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in bench)
    program = [e for e in events if e.get("cat") == "user_annotation"
               and str(e["name"]).startswith("spcl.")]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES
            and not str(e["name"]).startswith((span_prefix, "spcl."))]
    gaps = sorted(_gaps(events, lo, hi), key=lambda g: g[0] - g[1])[:top]

    def inner(group, t):
        cover = [e for e in group if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
        return max(cover, key=lambda e: float(e["ts"]))["name"] if cover else None

    out = []
    for a, b in gaps:
        t = (a + b) / 2
        names = [inner(bench, t) or "outside the spans", inner(program, t), inner(host, t)]
        out.append((" > ".join(n for n in names if n), (b - a) / 1e6))
    return out


def allocs_per_1k_steps(before: Dict[str, int], after: Dict[str, int], steps: int) -> float:
    """Device allocations and allocator retries (`spcl_torch.utils.profiling.
    allocator_counts` around a window) per 1,000 steps."""
    n = sum(after[k] - before[k] for k in ("device_allocs", "alloc_retries"))
    return 1e3 * n / steps


def span_calls(events: List[dict], steps: int, window: str = "portbench.stretch") -> float:
    """The program's spans opened a step in the window."""
    lo, hi = _window(events, window)
    return sum(1 for e in events if e.get("cat") == "user_annotation"
               and str(e["name"]).startswith("spcl.") and lo <= float(e["ts"]) < hi) / steps

