"""Accelerator busy/idle accounting — the paper's Table-3 columns.

The paper samples ``nvidia-smi`` at 10 Hz in a sidecar.  Here the same
statistics come from spans: a 100 ms window is "busy" by the fraction of it
covered by the train step's device-clock phase spans (``step_fwd_bwd``,
``step_grad_reduce``, ``step_optimizer``, recorded on a card), or where
there are none by the ``run_training_batch`` spans (each ends in a
``.item()`` read, so it covers the step's device work and the host's time
around it).

* ``util_zero_pct``  — % of windows with zero coverage  (GPU_util=0)
* ``util_pos_avg``   — mean coverage % over non-zero windows (GPU_util>0)

:func:`recent_busy_fraction` is the trainer's step-span coverage over a
trailing window, the autotuner's utilization gate; :func:`available_cpu_count` seeds the
staged pipeline's io/cpu thread split.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.tracing import (RUN_TRAINING_BATCH, STEP_PHASES, Span, Tracer,
                                      union_duration)


def _parse_cgroup_quota() -> Optional[int]:
    """Cores granted by the container's cpu controller, or None when
    unlimited / not containerized.  Checks cgroup v2 (``cpu.max``:
    ``"<quota_us> <period_us>"`` or ``"max <period_us>"``) then v1
    (``cfs_quota_us`` / ``cfs_period_us``, quota -1 = unlimited)."""
    try:
        with open("/sys/fs/cgroup/cpu.max", "r") as f:
            quota_s, period_s = f.read().split()[:2]
        if quota_s != "max":
            return max(1, int(int(quota_s) / int(period_s)))
        return None
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/sys/fs/cgroup/cpu/cpu.cfs_quota_us", "r") as f:
            quota = int(f.read())
        with open("/sys/fs/cgroup/cpu/cpu.cfs_period_us", "r") as f:
            period = int(f.read())
        if quota > 0 and period > 0:
            return max(1, quota // period)
    except (OSError, ValueError):
        pass
    return None


def available_cpu_count() -> int:
    """Cores this process may actually use: the minimum of the cgroup cpu
    quota and the scheduling affinity mask (``os.cpu_count()`` alone
    overstates it inside a quota'd container)."""
    counts = [c for c in (_parse_cgroup_quota(),) if c]
    proc_count = getattr(os, "process_cpu_count", None)
    if proc_count is not None:  # Python >= 3.13: affinity-aware
        counts.append(proc_count() or 1)
    elif hasattr(os, "sched_getaffinity"):
        counts.append(len(os.sched_getaffinity(0)) or 1)
    else:  # pragma: no cover - non-Linux fallback
        counts.append(os.cpu_count() or 1)
    return max(1, min(counts))


@dataclass
class UtilStats:
    util_zero_pct: float
    util_pos_avg: float
    busy_fraction: float
    wall_s: float


@dataclass
class AcceleratorStats(UtilStats):
    """:class:`UtilStats` with the spans they were read from:
    ``"device_phases"`` or ``"run_training_batch"``."""

    source: str = RUN_TRAINING_BATCH


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


def accelerator_stats(tracer: Tracer, t0: float, t1: float,
                      hz: float = 10.0) -> AcceleratorStats:
    """The Table-3 columns over ``[t0, t1]`` from the device-clock phase
    spans where the tracer holds them (a step traced on a card), else from
    the ``run_training_batch`` spans; ``source`` says which."""
    phases = [s for s in tracer.spans()
              if s.name in STEP_PHASES and s.args.get("clock") == "device"]
    if phases:
        return AcceleratorStats(**vars(sample_utilization(phases, t0, t1, hz)),
                                source="device_phases")
    return AcceleratorStats(**vars(sample_utilization(tracer.spans(RUN_TRAINING_BATCH),
                                                      t0, t1, hz)))


def recent_busy_fraction(
    tracer: Tracer, window_s: float = 2.0, now: Optional[float] = None
) -> Optional[float]:
    """Busy fraction over the trailing window, the live signal of the
    autotuner's utilization gate (``AutotuneConfig.util_gate``): the
    trainer's step-span coverage, host time around the step included,
    which is what the gate asks (does the step leave the trainer idle?).

    The window is anchored at the END of the last completed training-step
    span, not at the wall clock: a now-anchored window read mid-step would
    count the in-flight step's time as idle.  Returns ``None`` when there is
    no usable signal (no step span in recent history, or the last one ended
    too long ago): no signal, no gate."""
    t_now = time.monotonic() if now is None else now
    recent = tracer.recent_spans(RUN_TRAINING_BATCH, t_now - 3 * window_s)
    if not recent:
        return None
    anchor = max(s.t1 for s in recent)
    if t_now - anchor > 2 * window_s:
        return None  # stale: paused, or an in-flight step we can't see
    t1, t0 = anchor, anchor - window_s
    spans = [s for s in recent if s.t1 > t0 and s.t0 < t1]
    clipped = [Span(s.name, max(s.t0, t0), min(s.t1, t1), s.tid) for s in spans]
    return min(union_duration(clipped) / max(window_s, 1e-9), 1.0)
