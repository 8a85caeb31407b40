"""Span-level tracer — the paper's profiling methodology (Fig. 1 lanes).

Records named spans (``get_batch``, ``get_item``, ``batch_to_device``,
``run_training_batch``, the cache tiers' ``cache_get`` and the staged
pipeline's ``stage_*`` lanes, sharded delivery's ``lane_*`` and
``stage_compose`` lanes, the read path's ``serve_get``, the trainer's
``ring_wait`` and ``step_sync``) with wall-clock start/end and thread id,
like the log-entry instrumentation in the paper, plus named monotonic
counters (``bytes_copied``).  The train step's phases (``step_fwd_bwd``,
``step_grad_reduce``, ``step_optimizer``) are device spans
(:meth:`Tracer.device_span`): on a card, timed by CUDA events and mapped
onto the same monotonic clock; the step reaches the tracer through the
trainer's :func:`step_scope`.  Exports Chrome ``trace_event`` JSON
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
from typing import Any, Callable, ContextManager, Dict, Iterator, List, Optional, Sequence

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
# the trainer's lanes: its wait on the device prefetch ring's queue (tagged
# with the batches the ring had handed out), and the metrics' ``.item()``
# read inside each run_training_batch span (tagged with the step)
RING_WAIT = "ring_wait"
STEP_SYNC = "step_sync"
# the train step's phases, device spans tagged with the trainer's step: each
# microbatch's forward, backward and gradient sum (tagged mb=i), the
# data-parallel all-reduce with the metrics' group mean, and the optimizer
# (compression, norms, clip, update).  They tile the step's device work.
STEP_FWD_BWD = "step_fwd_bwd"
STEP_GRAD_REDUCE = "step_grad_reduce"
STEP_OPTIMIZER = "step_optimizer"
STEP_PHASES = (STEP_FWD_BWD, STEP_GRAD_REDUCE, STEP_OPTIMIZER)


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


def _is_cuda(device: Any) -> bool:
    return str(device).startswith("cuda")


class EventPairs:
    """Pairs of timing-enabled CUDA events recorded around device work on a
    stream, each handed to ``on_done(start, end, *tag)`` once its end event
    has completed.  :meth:`settle` asks each pair with ``query()`` and never
    waits, unless ``wait``: the host never blocks on a pair it timed."""

    def __init__(self, on_done: Callable[..., None]) -> None:
        self._on_done = on_done
        self._lock = threading.Lock()
        self._pending: List[tuple] = []

    @contextmanager
    def around(self, stream: Any, *tag: Any) -> Iterator[None]:
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            with self._lock:
                self._pending.append((start, end, tag))

    def settle(self, wait: bool = False) -> None:
        done: List[tuple] = []
        keep: List[tuple] = []
        with self._lock:
            for pair in self._pending:
                (done if wait or pair[1].query() else keep).append(pair)
            self._pending = keep
        for start, end, tag in done:
            end.synchronize()
            self._on_done(start, end, *tag)


class Tracer:
    """Thread-safe span recorder with bounded memory."""

    def __init__(self, max_spans: int = 2_000_000) -> None:
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._max = max_spans
        self._dropped = 0
        self._counters: Dict[str, float] = {}
        self.t_start = time.monotonic()
        self._pairs = EventPairs(self._record_device)
        # (host monotonic time, CUDA event recorded then): maps the device's
        # clock onto the host's; retaken after each step's sync (drift)
        self._anchor: Optional[tuple] = None

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

    @contextmanager
    def device_span(self, name: str, device: Any = None,
                    **args: Any) -> Iterator[Dict[str, Any]]:
        """A span around the device work enqueued in its body.  On a card
        (``device`` a CUDA device) a pair of timing-enabled CUDA events on
        the device's current stream, resolved into an ordinary span on the
        host's monotonic clock once the end event has completed (never
        waited for; see :meth:`device_synced`), with ``args["clock"] =
        "device"``, on its own lane.  Off a card a host span: CPU work is
        synchronous, so it times the same work."""
        if not _is_cuda(device):
            with self.span(name, **args) as extra:
                yield extra
            return
        import torch

        self._pairs.settle()
        stream = torch.cuda.current_stream(device)
        if self._anchor is None:
            torch.cuda.synchronize(device)
            self._take_anchor(stream)
            torch.cuda.synchronize(device)
        extra: Dict[str, Any] = {}
        with self._pairs.around(stream, name, args, extra, self._anchor,
                                -1 - stream.device.index):
            yield extra

    def device_synced(self, device: Any) -> None:
        """The host has just waited for ``device``'s current stream to
        drain (the trainer's ``.item()``): resolve the completed device
        spans and map the device's clock onto the host's again, which the
        drain lets do without a synchronize.  The two clocks drift apart
        by tens of ppm, milliseconds over a run.  Nothing before the first
        device span, off a card, or if the stream is still busy."""
        if self._anchor is None or not _is_cuda(device):
            return
        import torch

        self._pairs.settle()
        stream = torch.cuda.current_stream(device)
        if stream.query():
            self._take_anchor(stream)

    # an anchor's event is recorded between two reads of the host's clock at
    # most this far apart: another thread taking the GIL between a read and
    # the record would put the device's clock that much late
    _ANCHOR_BRACKET_S = 20e-6

    def _take_anchor(self, stream: Any) -> None:
        """Record an event on the idle ``stream`` between two reads of the
        host's clock, again while they lie too far apart (a few tries): the
        device stamps the event as it takes it, right after the record."""
        import torch

        best = None
        for _ in range(8):
            event = torch.cuda.Event(enable_timing=True)
            t0 = time.monotonic()
            event.record(stream)
            t1 = time.monotonic()
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, t1, event)
            if t1 - t0 <= self._ANCHOR_BRACKET_S:
                break
        self._anchor = best[1:]

    def _record_device(self, start: Any, end: Any, name: str, args: Dict[str, Any],
                       extra: Dict[str, Any], anchor: tuple, tid: int) -> None:
        t, event = anchor
        self.record(name, t + event.elapsed_time(start) / 1e3,
                    t + event.elapsed_time(end) / 1e3, tid=tid,
                    **{**args, **extra, "clock": "device"})

    def spans(self, name: Optional[str] = None) -> List[Span]:
        self._pairs.settle()
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
        self._pairs.settle(wait=True)
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
    """No-op tracer (default when profiling is off): records nothing, reads
    no clock and creates no CUDA event."""

    def __init__(self) -> None:
        super().__init__(max_spans=0)

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[Dict[str, Any]]:
        yield {}

    @contextmanager
    def device_span(self, name: str, device: Any = None,
                    **args: Any) -> Iterator[Dict[str, Any]]:
        yield {}

    def record(
        self, name: str, t0: float, t1: float, *,
        tid: Optional[int] = None, **args: Any,
    ) -> None:
        pass

    def count(self, name: str, n: float = 1) -> None:
        pass


NULL_TRACER = _NullTracer()

_scope = threading.local()


@contextmanager
def step_scope(tracer: Tracer, step: int, device: Any) -> Iterator[None]:
    """Make ``tracer``, the trainer's step number and the step's device
    current on this thread while a train step runs, so the step records its
    phases (:func:`phase`) with no argument of its own."""
    prev = getattr(_scope, "current", None)
    _scope.current = (tracer, step, device)
    try:
        yield
    finally:
        _scope.current = prev


def phase(name: str, **args: Any) -> ContextManager:
    """The current step's device span ``name``, tagged with its ``step``
    (:func:`step_scope`); outside a scope nothing, as under ``NULL_TRACER``."""
    tracer, step, device = getattr(_scope, "current", None) or (NULL_TRACER, 0, None)
    return tracer.device_span(name, device, step=step, **args)


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
