"""The readers of the train step's phases on synthetic records and traces,
and on a smoke cell's spans recorded by the program on the CPU."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchlib import devtrace, harness, phases
from benchlib.manifest import load_cell, reader

BENCH = Path(__file__).resolve().parents[1]
GRANITE = json.loads((BENCH / "configs/granite-8b-4l.json").read_text())
RESNET = json.loads((BENCH / "configs/resnet18-imagenet.json").read_text())
READERS = ("ring_wait_ms.tokens", "dispatch_ms.tokens", "fwd_bwd_ms.tokens",
           "optimizer_ms.tokens", "launch_idle_ms.tokens")


def _span(name, t0, t1, **args):
    return SimpleNamespace(name=name, t0=t0, t1=t1, args=args, duration=t1 - t0)


def _run(spans, cfg=GRANITE, trace=None, t0=0.0, t1=10.0):
    return SimpleNamespace(cfg=cfg, t0=t0, t1=t1, spans=spans, trace=trace,
                           spans_named=lambda n: [s for s in spans if s.name == n])


def _steps():
    """Two window steps of 1 s (steps 4 and 5) and one before the window
    (step 3): waits, host spans and device phases at known times."""
    spans = []
    for k, a in ((3, -1.0), (4, 1.0), (5, 2.5)):
        spans += [
            _span("ring_wait", a - 0.004 * (k - 2), a, handed=k),
            _span("run_training_batch", a, a + 1.0, step=k),
            # the host enqueues for 0.1 s (0.1 + k / 100 for step k), then waits
            _span("step_sync", a + 0.1 + k / 100, a + 1.0, step=k),
            _span("step_fwd_bwd", a + 0.01, a + 0.45, step=k, mb=0, clock="device"),
            _span("step_fwd_bwd", a + 0.45, a + 0.85, step=k, mb=1, clock="device"),
            _span("step_optimizer", a + 0.86, a + 0.99, step=k, clock="device"),
        ]
    return spans


def test_phase_readers_arithmetic():
    run = _run(_steps())
    assert [s.args["step"] for s in phases.window_steps(run)] == [4, 5]
    r = {n: reader(BENCH.parent, n)(run) for n in READERS}
    # waits of 8 and 12 ms inside the window; step 3's (4 ms) before it
    assert r["ring_wait_ms.tokens"] == pytest.approx(10.0)
    assert r["fwd_bwd_ms.tokens"] == pytest.approx(840.0)
    assert r["optimizer_ms.tokens"] == pytest.approx(130.0)
    # self time less step_sync: 0.14 and 0.15 s
    assert r["dispatch_ms.tokens"] == pytest.approx(145.0)
    assert r["launch_idle_ms.tokens"] is None  # no device trace


def test_dispatch_subtracts_only_the_sync_inside_the_step():
    spans = [_span("run_training_batch", 1.0, 2.0, step=0),
             # a sync that runs past the step's end counts only inside it
             _span("step_sync", 1.5, 2.5, step=0),
             _span("run_training_batch", 3.0, 4.0, step=1),
             _span("step_sync", 3.2, 3.4, step=1), _span("step_sync", 3.3, 3.6, step=1),
             # another step's sync is not a child
             _span("step_sync", 3.0, 3.9, step=7)]
    assert phases.dispatch_ms(_run(spans)) == pytest.approx(1e3 * (0.5 + 0.6) / 2)


def _trace(busy, t0=0.0, t1=10.0):
    return devtrace.DeviceTrace([("k", a, b) for a, b in busy], t0, t1)


def test_launch_idle_is_idle_inside_the_phases():
    # window steps 4 ([1, 2]) and 5 ([2.5, 3.5]); phases cover
    # [1.01, 1.85] + [1.86, 1.99] and [2.51, 3.35] + [3.36, 3.49]
    busy = [(1.01, 1.2), (1.25, 1.85),  # 50 ms idle mid-phase in step 4
            (1.86, 1.99),  # the 10 ms between its phases is not counted
            (2.51, 3.3), (3.33, 3.35),  # 30 ms mid-phase in step 5
            (3.36, 3.49)]  # and [3.35, 3.36] between its phases, not counted
    run = _run(_steps(), trace=_trace(busy))
    assert phases.launch_idle_ms(run) == pytest.approx((50.0 + 30.0) / 2)
    assert phases.intersection_s([(0.0, 1.0), (2.0, 3.0)], [(0.5, 2.5)]) == pytest.approx(1.0)
    assert phases.intersection_s([(0.0, 1.0)], [(1.0, 2.0)]) == 0.0
    # host-clock phases (a CPU run) do not meet a device trace
    host = [s for s in _steps() if s.name != "step_optimizer"]
    for s in host:
        s.args.pop("clock", None)
    assert phases.launch_idle_ms(_run(host, trace=_trace(busy))) is None


def test_launch_idle_stretches_the_trace_onto_the_host_window():
    """A trace whose clock ran 1,000 ppm slow, mapped as the harness maps
    it (its middle where the mean of the two markers' offsets puts it, its
    ends 5 ms off a 10 s window's): its gaps are stretched about the middle
    onto the run's window before they meet the spans."""
    busy = [(1.01, 1.2), (1.25, 1.85), (1.86, 1.99), (2.51, 3.3), (3.33, 3.35), (3.36, 3.49)]
    k = 1 - 1e-3

    def mapped(t):
        return 5.0 + (t - 5.0) * k

    slow = devtrace.DeviceTrace([("k", mapped(a), mapped(b)) for a, b in busy],
                                mapped(0.0), mapped(10.0))
    run = _run(_steps(), trace=slow)
    assert slow.idle_gaps()[1] == pytest.approx((1.2038, 1.25375))
    assert phases.host_clock_gaps(run)[1] == pytest.approx((1.2, 1.25))
    assert phases.launch_idle_ms(run) == pytest.approx(40.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_phase_spans_and_for_images(name):
    read = reader(BENCH.parent, name)
    # a program without the phase spans (as the parent's): only the steps
    old = [s for s in _steps() if s.name == "run_training_batch"]
    assert read(_run(old, trace=_trace([(1.0, 2.0)]))) is None
    assert read(_run([], trace=None)) is None
    assert read(_run(_steps(), cfg=RESNET, trace=_trace([(1.0, 2.0)]))) is None


def test_a_smoke_cell_traced_on_the_cpu_feeds_the_readers(smoke_root, monkeypatch):
    """The program's own spans, from a smoke decoder cell run with its tracer
    on (no profiler on the CPU, so no device trace)."""
    class Traced(harness.Program):
        def __init__(self, *args, traced, **kw):
            super().__init__(*args, traced=True, **kw)

    monkeypatch.setattr(harness, "Program", Traced)
    cell = load_cell(smoke_root, "smoke-decoder.smoke-s3sim")
    run = harness.run(cell, 2**31 + 11, 0.5, False, torch.device("cpu"), 0.0)["record"]
    steps = phases.window_steps(run)
    assert len(steps) == run.steps >= 1
    got = {n: reader(smoke_root, n)(run) for n in READERS}
    assert got.pop("launch_idle_ms.tokens") is None
    assert all(v is not None and v >= 0 for v in got.values()), got
    step_ms = 1e3 * sum(s.duration for s in steps) / len(steps)
    assert got["fwd_bwd_ms.tokens"] + got["optimizer_ms.tokens"] <= step_ms
    assert got["dispatch_ms.tokens"] <= step_ms
