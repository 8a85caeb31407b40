"""Twins of ``tests/test_tracing_util.py`` on the port alone (tracer
thread safety, bounded spans, the Chrome-trace export, utilization), the
same cases and assertions with the imports pointed at ``repro_torch``."""
import json
import threading
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.core.tracing import (  # noqa: E402
    RUN_TRAINING_BATCH,
    Span,
    Tracer,
    union_duration,
)
from repro_torch.core.utilization import sample_utilization  # noqa: E402


def test_span_recording_and_median():
    tr = Tracer()
    with tr.span("a", idx=1):
        time.sleep(0.01)
    tr.record("a", 0.0, 0.5)
    assert len(tr.spans("a")) == 2
    assert tr.median("a") > 0.0
    assert tr.spans("a")[0].args == {"idx": 1}


def test_span_meta_injection():
    tr = Tracer()
    with tr.span("x") as meta:
        meta["nbytes"] = 42
    assert tr.spans("x")[0].args["nbytes"] == 42


def test_tracer_thread_safety():
    tr = Tracer()

    def work():
        for _ in range(200):
            tr.record("t", 0.0, 1.0)

    ts = [threading.Thread(target=work) for _ in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert len(tr.spans("t")) == 1600


def test_union_duration_overlaps():
    spans = [Span("s", 0.0, 1.0, 0), Span("s", 0.5, 2.0, 0), Span("s", 3.0, 4.0, 0)]
    assert union_duration(spans) == pytest.approx(3.0)
    assert union_duration([]) == 0.0


def test_chrome_trace_export(tmp_path):
    tr = Tracer()
    with tr.span("phase", k="v"):
        pass
    p = tmp_path / "trace.json"
    tr.dump(str(p))
    data = json.loads(p.read_text())
    assert data["traceEvents"][0]["name"] == "phase"


def test_bounded_spans():
    tr = Tracer(max_spans=10)
    for _ in range(20):
        tr.record("x", 0, 1)
    assert len(tr.spans()) == 10
    assert tr._dropped == 10


def test_utilization_idle_vs_busy():
    # 10 s wall; busy only during [2, 3] -> util_zero ~90%, busy_fraction 0.1
    spans = [Span(RUN_TRAINING_BATCH, 2.0, 3.0, 0)]
    st = sample_utilization(spans, 0.0, 10.0, hz=10.0)
    assert st.util_zero_pct == pytest.approx(90.0, abs=2.0)
    assert st.busy_fraction == pytest.approx(0.1, abs=0.01)
    assert st.util_pos_avg > 95.0


def test_utilization_fully_busy():
    spans = [Span(RUN_TRAINING_BATCH, 0.0, 10.0, 0)]
    st = sample_utilization(spans, 0.0, 10.0)
    assert st.util_zero_pct == 0.0
    assert st.busy_fraction == pytest.approx(1.0)


def test_utilization_no_spans():
    st = sample_utilization([], 0.0, 5.0)
    assert st.util_zero_pct == 100.0
    assert st.util_pos_avg == 0.0


# -- device spans, the step scope and the null tracer ------------------------

from repro_torch.core import tracing  # noqa: E402
from repro_torch.core.utilization import accelerator_stats  # noqa: E402


class _FakeCard:
    """Stands in for ``torch.cuda``'s events and streams on the CPU: an
    event takes the device clock ``dev`` when recorded and has completed
    once ``done`` has reached it; the host clock is ``host``."""

    def __init__(self):
        self.host, self.dev, self.done, self.events = 100.0, 5.0, 0.0, 0
        self.idle = True
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                card.events += 1

            def record(self, stream=None):
                self.t = card.dev

            def query(self):
                return self.t <= card.done

            def synchronize(self):
                card.done = max(card.done, self.t)

            def elapsed_time(self, other):
                return 1e3 * (other.t - self.t)

        class Stream:
            device = SimpleNamespace(index=0)

            def query(self):
                return card.idle

        self.Event, self.stream = Event, Stream()


def _fake_card(monkeypatch):
    import torch

    card = _FakeCard()
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: card.stream)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(tracing.time, "monotonic", lambda: card.host)
    return card


def test_device_spans_resolve_lazily_on_the_anchored_clock(monkeypatch):
    card = _fake_card(monkeypatch)
    tr = Tracer()
    with tr.device_span("a", "cuda:0", step=3):
        card.dev = 5.2  # the device ran 200 ms of work
    card.done = 5.1
    assert tr.spans("a") == []  # its end event has not completed: not waited for
    card.done = 5.2
    (a,) = tr.spans("a")
    assert (a.t0, a.t1) == pytest.approx((100.0, 100.2))
    assert a.args == {"step": 3, "clock": "device"} and a.tid == -1
    # the device's clock ran 50 ms ahead of the host's meanwhile: a busy
    # stream keeps the old anchor, a drained one is anchored anew
    card.host, card.dev = 101.0, 6.05
    card.idle = False
    tr.device_synced("cuda:0")
    with tr.device_span("b", "cuda:0"):
        card.dev = 6.15
    card.done = 6.15
    assert tr.spans("b")[0].t0 == pytest.approx(101.05)
    card.host, card.dev = 101.2, 6.25
    card.idle = True
    tr.device_synced("cuda:0")
    with tr.device_span("c", "cuda:0"):
        card.dev = 6.35
    card.done = 6.35
    assert (tr.spans("c")[0].t0, tr.spans("c")[0].t1) == pytest.approx((101.2, 101.3))
    # the first span anchored once, then one anchor a drained sync
    assert card.events == 2 * 3 + 2


def test_off_a_card_a_device_span_is_a_host_span():
    tr = Tracer()
    with tr.device_span("x", "cpu", step=1) as extra:
        extra["k"] = 2
    tr.device_synced("cpu")
    assert [(s.name, s.args) for s in tr.spans()] == [("x", {"step": 1, "k": 2})]


def test_null_tracer_records_nothing_reads_no_clock_and_makes_no_event(monkeypatch):
    import torch

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.train.steps import init_train_state, make_train_step

    def refuse(*a, **k):
        raise AssertionError("the null tracer touched a clock or an event")

    cfg = get_arch("granite-8b", smoke=True)
    tcfg = TrainConfig(microbatches=2)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, tcfg)
    toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing.time, "monotonic", refuse)
    with tracing.step_scope(tracing.NULL_TRACER, 0, "cuda:0"):
        step(state, batch)
        with tracing.phase("p"):
            pass
    with tracing.NULL_TRACER.device_span("d", "cuda:0"), tracing.NULL_TRACER.span("s"):
        pass
    tracing.NULL_TRACER.device_synced("cuda:0")
    with tracing.phase("outside_any_scope"):
        pass
    assert tracing.NULL_TRACER.spans() == []


def test_accelerator_stats_reads_device_phases_where_there_are_any():
    tr = Tracer()
    tr.record(RUN_TRAINING_BATCH, 0.0, 10.0, step=0)
    st = accelerator_stats(tr, 0.0, 10.0)
    assert st.source == RUN_TRAINING_BATCH and st.busy_fraction == pytest.approx(1.0)
    tr.record(tracing.STEP_FWD_BWD, 1.0, 3.0, step=0, mb=0)  # a host span (CPU)
    assert accelerator_stats(tr, 0.0, 10.0).source == RUN_TRAINING_BATCH
    tr.record(tracing.STEP_FWD_BWD, 1.0, 4.0, step=0, mb=0, clock="device")
    tr.record(tracing.STEP_OPTIMIZER, 4.0, 6.0, step=0, clock="device")
    st = accelerator_stats(tr, 0.0, 10.0)
    assert st.source == "device_phases" and st.busy_fraction == pytest.approx(0.5)


@pytest.mark.cuda
def test_device_phase_spans_lie_inside_their_step_on_the_card():
    """On the card, through ``Trainer.fit``: each step's device phases lie
    within [run_training_batch.t0, step_sync.t1 + 50 us] on the anchored
    clock, one after another, in the order the step enqueues them."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA events)")
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

    cfg = get_arch("granite-8b", smoke=True)
    tcfg = TrainConfig(microbatches=2)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    rng = torch.Generator().manual_seed(1)
    batches = []
    for _ in range(6):
        toks = torch.randint(0, cfg.vocab_size, (4, 257), generator=rng, dtype=torch.int32)
        batches.append({"tokens": toks[:, :-1].numpy(), "targets": toks[:, 1:].numpy()})
    tr = Tracer()
    Trainer(make_train_step(cfg, tcfg), state, tracer=tr, device="cuda").fit(batches)
    for step in range(6):
        (rtb,) = [s for s in tr.spans(RUN_TRAINING_BATCH) if s.args["step"] == step]
        (sync,) = [s for s in tr.spans(tracing.STEP_SYNC) if s.args["step"] == step]
        phases = sorted((s for s in tr.spans() if s.name in tracing.STEP_PHASES
                         and s.args["step"] == step), key=lambda s: s.t0)
        assert [(s.name, s.args.get("mb")) for s in phases] == [
            (tracing.STEP_FWD_BWD, 0), (tracing.STEP_FWD_BWD, 1), (tracing.STEP_OPTIMIZER, None)]
        assert all(s.args["clock"] == "device" for s in phases)
        assert phases[0].t0 >= rtb.t0 and phases[-1].t1 <= sync.t1 + 50e-6
        assert all(a.t1 <= b.t0 for a, b in zip(phases, phases[1:]))
