"""Span-level tracer — the paper's profiling methodology (Fig. 1 lanes).

Records named spans (``get_batch``, ``get_item``, ``batch_to_device``,
``run_training_batch``, the cache tiers' ``cache_get`` and the staged
pipeline's ``stage_*`` lanes, sharded delivery's ``lane_*`` and
``stage_compose`` lanes, the read path's ``serve_get``) with
wall-clock start/end and thread id, like the log-entry instrumentation in
the paper, plus named monotonic counters
(``bytes_copied``).  Exports Chrome ``trace_event`` JSON
(:meth:`Tracer.dump`) so the Fig. 1 lanes open in Perfetto, and feeds the
Table-3 busy/idle statistics (:mod:`repro_torch.core.utilization`) and the
autotuner's windowed views (:meth:`Tracer.recent_spans`,
:func:`window_summary`).
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

# Canonical lane names (paper Fig. 1)
GET_BATCH = "get_batch"
GET_ITEM = "get_item"
BATCH_TO_DEVICE = "batch_to_device"
RUN_TRAINING_BATCH = "run_training_batch"
# cache-subsystem lane: one span per TieredCacheStore GET, tagged with the
# serving tier (memory | disk | origin)
CACHE_GET = "cache_get"
# staged-pipeline lanes (repro_torch.core.pipeline): one span per sample per
# stage (fetch on the IO executor, decode/augment on the CPU executor) and
# one collate span per assembled batch
STAGE_FETCH = "stage_fetch"
STAGE_DECODE = "stage_decode"
STAGE_AUGMENT = "stage_augment"
STAGE_COLLATE = "stage_collate"
# sharded-delivery lanes (repro_torch.core.delivery): per lane, one collate
# span and one host-to-device span a batch (tagged lane=i), and one compose
# span a global batch
LANE_COLLATE = "lane_collate"
LANE_H2D = "lane_h2d"
STAGE_COMPOSE = "stage_compose"
# serving read path (repro_torch.serve.readpath): one span per ReadPath.get,
# tagged with tenant, serving source (memory | disk | coalesced | fetch),
# and whether a hedge fired
SERVE_GET = "serve_get"
# monotonic counter (not a span lane): host bytes copied on a sample's way
# from decode to the collated batch (collate's pass, and the process CPU
# stage's pickle both ways)
BYTES_COPIED = "bytes_copied"
# shuffle-quality lane: one span per measurement window of the delivered
# index stream, tagged with its within- and across-batch entropies
SHUFFLE_ENTROPY = "shuffle_entropy"


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    tid: int
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Thread-safe span recorder with bounded memory."""

    def __init__(self, max_spans: int = 2_000_000) -> None:
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._max = max_spans
        self._dropped = 0
        self._counters: Dict[str, float] = {}
        self.t_start = time.monotonic()

    def count(self, name: str, n: float = 1) -> None:
        """Bump a named monotonic counter (e.g. :data:`BYTES_COPIED`)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def record(
        self, name: str, t0: float, t1: float, *,
        tid: Optional[int] = None, **args: Any,
    ) -> None:
        """Record one span.  ``tid`` overrides the recording thread's id: the
        process CPU stage records spans on behalf of a worker process (its
        pid), from ``time.monotonic`` endpoints the worker shipped home."""
        span = Span(name, t0, t1,
                    threading.get_ident() if tid is None else int(tid), args)
        with self._lock:
            if len(self._spans) < self._max:
                self._spans.append(span)
            else:
                self._dropped += 1

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[Dict[str, Any]]:
        t0 = time.monotonic()
        extra: Dict[str, Any] = {}
        try:
            yield extra
        finally:
            t1 = time.monotonic()
            if extra:
                args.update(extra)
            self.record(name, t0, t1, **args)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    # threads record() spans in completion order, give or take this much
    _REORDER_SLACK_S = 1.0

    def recent_spans(self, name: str, since: float) -> List[Span]:
        """Spans named ``name`` that ended at or after ``since``, oldest
        first.  Walks the record backward and stops once spans end before
        the window (minus a reorder slack), so the cost is O(matches): the
        query the autotuner's utilization gate issues every window."""
        out: List[Span] = []
        with self._lock:
            for s in reversed(self._spans):
                if s.t1 < since - self._REORDER_SLACK_S:
                    break
                if s.name == name and s.t1 >= since:
                    out.append(s)
        out.reverse()
        return out

    def durations(self, name: str) -> List[float]:
        return [s.duration for s in self.spans(name)]

    def median(self, name: str) -> float:
        ds = sorted(self.durations(name))
        if not ds:
            return float("nan")
        n = len(ds)
        return ds[n // 2] if n % 2 else 0.5 * (ds[n // 2 - 1] + ds[n // 2])

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._dropped = 0
        self.t_start = time.monotonic()

    # -- export ------------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` form: one complete ("X") event per span,
        times in microseconds, each thread (or worker pid) its own lane."""
        events = []
        for s in self.spans():
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "ts": s.t0 * 1e6,
                    "dur": (s.t1 - s.t0) * 1e6,
                    "pid": 0,
                    "tid": s.tid % 1_000_000,
                    "args": {k: repr(v) for k, v in s.args.items()},
                }
            )
        return {"traceEvents": events}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


class _NullTracer(Tracer):
    """No-op tracer (default when profiling is off)."""

    def __init__(self) -> None:
        super().__init__(max_spans=0)

    def record(
        self, name: str, t0: float, t1: float, *,
        tid: Optional[int] = None, **args: Any,
    ) -> None:
        pass

    def count(self, name: str, n: float = 1) -> None:
        pass


NULL_TRACER = _NullTracer()


@dataclass(frozen=True)
class StageWindow:
    """Aggregate statistics for one span name over a time window."""

    name: str
    count: int
    mean_s: float
    p50_s: float
    p95_s: float
    total_s: float

    @property
    def rate_per_s(self) -> float:
        return self.count / self.total_s if self.total_s > 0 else 0.0


def _pctl(sorted_xs: List[float], q: float) -> float:
    return sorted_xs[min(int(q * len(sorted_xs)), len(sorted_xs) - 1)]


def window_summary(
    tracer: Tracer, names: Sequence[str], since: float, until: Optional[float] = None
) -> Dict[str, StageWindow]:
    """Per-stage latency aggregation over spans that *ended* in
    ``[since, until)``: the autotuner's windowed view of the loader.  Names
    with no spans in the window map to a zero-count window."""
    if until is None:
        until = time.monotonic()
    wanted = set(names)
    durs: Dict[str, List[float]] = {n: [] for n in names}
    for s in tracer.spans():
        if s.name in wanted and since <= s.t1 < until:
            durs[s.name].append(s.duration)
    out: Dict[str, StageWindow] = {}
    for n in names:
        ds = sorted(durs[n])
        if not ds:
            out[n] = StageWindow(n, 0, 0.0, 0.0, 0.0, max(until - since, 0.0))
            continue
        out[n] = StageWindow(
            name=n,
            count=len(ds),
            mean_s=sum(ds) / len(ds),
            p50_s=_pctl(ds, 0.5),
            p95_s=_pctl(ds, 0.95),
            total_s=max(until - since, 0.0),
        )
    return out


def union_duration(spans: List[Span]) -> float:
    """Total wall time covered by the union of (possibly overlapping) spans."""
    if not spans:
        return 0.0
    ivs = sorted((s.t0, s.t1) for s in spans)
    total = 0.0
    cur0, cur1 = ivs[0]
    for t0, t1 in ivs[1:]:
        if t0 > cur1:
            total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    total += cur1 - cur0
    return total
