"""The device's timeline over the traced window, from ``torch.profiler``.

The window is marked on the device by two launches of
``torch.cuda._sleep`` (its kernel is ``spin_kernel``; the program never
launches it), each right after a synchronize and a read of the host's
monotonic clock, so the trace's clock maps onto the spans' to within a
launch's latency.  The device is busy where any kernel, copy or memset
runs, on any stream; the rest of the window is idle.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
# program spans that name what the host was doing during an idle gap
HOST_SPANS = ("run_training_batch", "batch_to_device", "stage_collate")

Interval = Tuple[float, float]


@dataclass
class DeviceTrace:
    """Device operations (name, start, end) on the host's monotonic clock,
    and the traced window [t0, t1]."""

    ops: List[Tuple[str, float, float]]
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Interval]:
        return union([(max(a, self.t0), min(b, self.t1)) for _, a, b in self.ops
                      if b > self.t0 and a < self.t1])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> List[Interval]:
        gaps, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < self.t1:
            gaps.append((at, self.t1))
        return gaps

    def durations(self, substring: str) -> List[float]:
        """Seconds of each operation in the window whose name holds ``substring``."""
        return [b - a for n, a, b in self.ops
                if substring in n and a >= self.t0 and b <= self.t1]

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        for name, a, b in self.ops:
            if a >= self.t0 and b <= self.t1:
                total[name] = total.get(name, 0.0) + (b - a)
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def from_events(events: Sequence[Dict], host_marks: Tuple[float, float]) -> DeviceTrace:
    """Chrome-trace events (``ts``/``dur`` in microseconds) -> a trace on
    the host clock, aligned by the two marker kernels."""
    ops = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    marks = sorted(a for n, a, _ in ops if MARKER in n)
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} window markers ({MARKER}), not 2: "
                           "the profiler recorded no device activity")
    offset = ((marks[0] - host_marks[0]) + (marks[-1] - host_marks[1])) / 2
    ops = [(n, a - offset, b - offset) for n, a, b in ops if MARKER not in n]
    return DeviceTrace(ops, marks[0] - offset, marks[-1] - offset)


def load(path: Path, host_marks: Tuple[float, float]) -> DeviceTrace:
    with open(path) as f:
        return from_events(json.load(f)["traceEvents"], host_marks)


def name_gaps(gaps: List[Interval], spans: Sequence, top: int = 10) -> List[List]:
    """Idle seconds by the program spans open at each gap's middle (``spans``:
    objects with ``name``, ``t0``, ``t1``), largest first."""
    host = [s for s in spans if s.name in HOST_SPANS]
    by: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = sorted({s.name for s in host if s.t0 <= mid < s.t1})
        key = "+".join(open_) or "no_program_span"
        by[key] = by.get(key, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
