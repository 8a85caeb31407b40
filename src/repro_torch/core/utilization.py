"""Accelerator busy/idle accounting — the paper's Table-3 columns.

The paper samples ``nvidia-smi`` at 10 Hz in a sidecar.  Here the same
statistics come from the step-execution spans: a 100 ms window is "busy" by
the fraction of it covered by ``run_training_batch`` spans (each span ends in
a ``.item()`` read, so it covers the step's device work).

* ``util_zero_pct``  — % of windows with zero coverage  (GPU_util=0)
* ``util_pos_avg``   — mean coverage % over non-zero windows (GPU_util>0)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core.tracing import RUN_TRAINING_BATCH, Span, Tracer, union_duration


@dataclass
class UtilStats:
    util_zero_pct: float
    util_pos_avg: float
    busy_fraction: float
    wall_s: float


def _coverage(spans: Sequence[Span], w0: float, w1: float) -> float:
    cov = 0.0
    for s in spans:
        lo, hi = max(s.t0, w0), min(s.t1, w1)
        if hi > lo:
            cov += hi - lo
    return min(cov / (w1 - w0), 1.0)


def sample_utilization(
    spans: Sequence[Span], t0: float, t1: float, hz: float = 10.0
) -> UtilStats:
    wall = max(t1 - t0, 1e-9)
    dt = 1.0 / hz
    n = max(int(wall / dt), 1)
    zero = 0
    pos: List[float] = []
    spans = sorted(spans, key=lambda s: s.t0)
    j0 = 0
    for w in range(n):
        w0 = t0 + w * dt
        w1 = min(w0 + dt, t1)
        # advance start pointer past spans that ended before this window
        while j0 < len(spans) and spans[j0].t1 < w0:
            j0 += 1
        j = j0
        window_spans = []
        while j < len(spans) and spans[j].t0 < w1:
            window_spans.append(spans[j])
            j += 1
        c = _coverage(window_spans, w0, w1)
        if c <= 0.0:
            zero += 1
        else:
            pos.append(c)
    busy = union_duration(list(spans)) / wall
    return UtilStats(
        util_zero_pct=100.0 * zero / n,
        util_pos_avg=100.0 * (sum(pos) / len(pos) if pos else 0.0),
        busy_fraction=busy,
        wall_s=wall,
    )


def accelerator_stats(tracer: Tracer, t0: float, t1: float, hz: float = 10.0) -> UtilStats:
    return sample_utilization(tracer.spans(RUN_TRAINING_BATCH), t0, t1, hz)
