"""Twins of ``tests/test_tracing_util.py`` on the port alone (tracer
thread safety, bounded spans, the Chrome-trace export, utilization), the
same cases and assertions with the imports pointed at ``repro_torch``."""
import json
import threading
import time

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
