"""The reduction of the program's spans (`portbench/spans.py`) on small
hand-written chrome traces: a kernel goes to its phase and stage by the
correlation of its launch; a backward kernel launched from the autograd
engine's thread goes to the step thread's phase and, by the sequence number
of its node, to the stage of the forward op that made it; the boundary's
idle under the epoch spans; the unattributed share; the idle gaps named by
the innermost span; `trace.reduce`'s numbers are the same with and without
the program's spans; a trace without them reads None."""
import pytest

from portbench import manifest, measure_spans, spans, trace
from portbench.tests import tiny

MAIN, AUTOGRAD, STREAM = 1, 2, 7


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _op(name, ts, dur, tid=MAIN, seq=None):
    args = {} if seq is None else {"Sequence number": seq}
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _launch(corr, ts, tid=MAIN, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(corr, ts, dur, name=None, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name or f"k{corr}", "ts": ts, "dur": dur,
            "tid": STREAM, "args": {"correlation": corr}}


def _stretch():
    """One step: input 30 us, forward 100 (Conv1 50, Conv3 50), loss 20,
    backward 155 on the autograd thread (Conv1's node 100, Conv3's 55),
    optimizer 10 (a copy), 5 under the bare `spcl.step`."""
    return [
        _span("portbench.stretch", 0, 1000), _span("portbench.step", 1, 998),
        _span("spcl.step", 10, 890),
        _span("spcl.step.input", 10, 90), _launch(1, 20), _kernel(1, 30, 30),
        _span("spcl.step.forward", 100, 300),
        _span("spcl.unet.Conv1", 110, 90), _op("aten::conv2d", 120, 30, seq=5),
        _launch(2, 130), _kernel(2, 140, 50),
        _span("spcl.unet.Conv3", 200, 100), _op("aten::convolution", 210, 40, seq=6),
        _launch(3, 220), _kernel(3, 230, 50),
        _span("spcl.step.loss", 400, 100), _launch(4, 410), _kernel(4, 420, 20),
        _span("spcl.step.backward", 500, 300),
        _op("autograd::engine::evaluate_function: ConvolutionBackward0", 520, 80,
            tid=AUTOGRAD, seq=5),
        _op("ConvolutionBackward0", 521, 78, tid=AUTOGRAD, seq=5),
        _launch(5, 530, tid=AUTOGRAD), _kernel(5, 540, 100),
        _op("autograd::engine::evaluate_function: ConvolutionBackward0", 610, 90,
            tid=AUTOGRAD, seq=6),
        _launch(6, 620, tid=AUTOGRAD), _kernel(6, 645, 55),
        _op("aten::empty", 740, 40),
        _span("spcl.step.optimizer", 800, 80),
        _launch(7, 810, name="cudaMemcpyAsync"), _kernel(7, 815, 10, "Memcpy DtoD",
                                                         "gpu_memcpy"),
        _launch(8, 885), _kernel(8, 890, 5),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "spcl.step", "ts": 30, "dur": 865,
         "tid": STREAM},
    ]


def test_kernels_go_to_their_phase_by_correlation():
    got = spans.step_metrics(_stretch(), steps=1)
    assert got["phase.input_ms"] == pytest.approx(0.030)
    assert got["phase.forward_ms"] == pytest.approx(0.100)
    assert got["phase.loss_ms"] == pytest.approx(0.020)
    assert got["phase.optimizer_ms"] == pytest.approx(0.010)
    assert got["phase.teacher_ms"] is None and got["phase.ema_ms"] is None
    assert got["gradcache.pass_a_ms"] is None


def test_backward_kernels_go_to_their_phase_and_stage_across_threads():
    rows = spans.attribute(_stretch())
    backward = [r for r in rows if r["phase"] == "spcl.step.backward"]
    assert [(r["dur"], r["stage"]) for r in backward] == [(100.0, "spcl.unet.Conv1"),
                                                           (55.0, "spcl.unet.Conv3")]
    got = spans.step_metrics(_stretch(), steps=1)
    assert got["phase.backward_ms"] == pytest.approx(0.155)
    assert got["unet.conv12_ms"] == pytest.approx(0.150)  # Conv1 forward 50 + backward 100
    assert spans.stage_ms(_stretch(), steps=1) == pytest.approx(
        {"spcl.unet.Conv1": 0.150, "spcl.unet.Conv3": 0.105, "none": 0.065})


def test_unattributed_share_and_the_sum_of_the_phases():
    got = spans.step_metrics(_stretch(), steps=1)
    assert got["phase.unattributed_pct"] == pytest.approx(100 * 5 / 320)
    phases = sum(v for k, v in got.items() if k.startswith("phase.") and k.endswith("_ms")
                 and v is not None)
    assert phases / (1 - got["phase.unattributed_pct"] / 100) == pytest.approx(0.320)


def test_overlapping_events_count_each_instant_once():
    """A copy on another stream under a kernel: the phases add up to
    `trace.reduce`'s busy time, the later event keeping what the earlier
    one leaves uncovered."""
    events = _stretch() + [_launch(9, 412), _kernel(9, 430, 20, "Memcpy HtoD", "gpu_memcpy")]
    got = spans.step_metrics(events, steps=1)
    assert got["phase.loss_ms"] == pytest.approx(0.030)  # 420-440, then 440-450
    named = sum(v for k, v in got.items() if k.startswith("phase.") and k.endswith("_ms")
                and v is not None)
    assert named / (1 - got["phase.unattributed_pct"] / 100) == pytest.approx(
        trace.reduce(events)["busy_us"] / 1e3)


def test_pass_a_kernels():
    events = [_span("portbench.stretch", 0, 100), _span("spcl.step", 0, 100),
              _span("spcl.gradcache.pass_a", 0, 50), _span("spcl.step.forward", 5, 40),
              _launch(1, 10), _kernel(1, 12, 20), _span("spcl.step.forward", 60, 30),
              _launch(2, 70), _kernel(2, 72, 8)]
    got = spans.step_metrics(events, steps=2)
    assert got["gradcache.pass_a_ms"] == pytest.approx(0.010)
    assert got["phase.forward_ms"] == pytest.approx(0.014)


def test_idle_at_the_boundary_under_the_epoch_spans():
    events = [
        _span("portbench.boundary", 0, 1000),
        _span("spcl.step", 0, 200), _launch(1, 10), _kernel(1, 50, 100),
        _span("spcl.epoch.drain", 200, 100), _launch(2, 205, name="cudaMemcpyAsync"),
        _kernel(2, 210, 20, "Memcpy DtoH", "gpu_memcpy"),
        _span("spcl.epoch.stats", 300, 200),
        _span("spcl.epoch.schedule", 500, 50), _launch(3, 510), _kernel(3, 520, 10),
        _span("spcl.epoch.rows", 550, 50),
        _span("spcl.epoch.upload", 600, 100), _launch(4, 630, name="cudaMemcpyAsync"),
        _kernel(4, 640, 20, "Memcpy HtoD", "gpu_memcpy"),
        _span("spcl.step", 700, 300), _launch(5, 710), _kernel(5, 800, 190)]
    got = spans.boundary_idle(events)
    # gaps: 0-50 and 150-210 under a step; 230-520 (middle in stats); 530-640
    # (middle in rows); 660-800 under a step; 990-1000 under a step
    assert got == pytest.approx({"total": 0.400, "spcl.epoch.stats": 0.290,
                                 "spcl.epoch.rows": 0.110})


def test_idle_gaps_carry_the_innermost_program_span():
    gaps = spans.idle_gaps(_stretch(), top=4)
    assert [name for name, _ in gaps] == [
        "portbench.step > spcl.step.forward",
        "portbench.step > spcl.step.backward > aten::empty", "portbench.step",
        "portbench.step > spcl.step.loss"]
    assert [s for _, s in gaps] == pytest.approx([140e-6, 115e-6, 105e-6, 100e-6])


def test_trace_reduce_is_unchanged_by_the_program_spans():
    events = _stretch()
    bare = [e for e in events if not str(e["name"]).startswith("spcl.")]
    with_spans, without = trace.reduce(events), trace.reduce(bare)
    for key in ("kernels", "launches", "busy_us", "span_us", "device_ops"):
        assert with_spans[key] == without[key], key


def test_a_trace_without_the_program_spans_reads_none():
    bare = [e for e in _stretch() if not str(e["name"]).startswith("spcl.")]
    assert set(spans.step_metrics(bare, steps=1).values()) == {None}
    assert spans.boundary_idle([dict(e, name="portbench.boundary") if e["name"] ==
                                "portbench.stretch" else e for e in bare]) is None


def test_allocations_per_thousand_steps():
    before = {"device_allocs": 10, "alloc_retries": 1}
    after = {"device_allocs": 14, "alloc_retries": 2}
    assert spans.allocs_per_1k_steps(before, after, steps=500) == pytest.approx(10.0)


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]])
def test_the_runner_measures_each_cell_at_the_tiny_size(workload):
    """`measure_spans.py` on the CPU: the window, the stretch and the
    boundary run; the program's spans are there, the device numbers are not."""
    got = measure_spans.measure(workload, 2 ** 31 + 7, 0.05, device="cpu",
                                overrides=tiny.overrides(workload))
    assert got["failed"] == 0 and got["window_steps"] >= 1
    assert got["span_calls_per_step"] >= 7 and got["span_off_us"] > 0
    assert got["launches_per_step"] == 0 and got["phase.unattributed_pct"] is None
    assert got["boundary_idle_by_span_ms"]["total"] >= 0
