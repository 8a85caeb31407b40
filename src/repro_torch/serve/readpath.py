"""Multi-tenant online-serving read path over the tiered cache + fetcher stack.

The training loaders optimize epoch wall-time; :class:`ReadPath` serves the
second workload: many users issuing skewed, bursty reads against the same
``TieredCacheStore``/origin stack, where the metric is *tail latency*.  Three mechanisms, each independently configurable through
:class:`repro_torch.config.ServeSpec`:

* **Single-flight coalescing** — concurrent misses on one key share a single
  backend fetch (one leader, N waiters); the completed result is held for
  ``coalesce_window_s`` so a flash crowd arriving just after completion still
  coalesces instead of stampeding the origin.  A crashed leader wakes every
  waiter and exactly one re-registers as the retry leader.
* **Per-tenant fairness** — token-bucket byte budgets on the *shared* tiers
  (:class:`repro_torch.config.TenantPolicy`): disk-tier and origin service debit
  the tenant's bucket (memory hits are free), and a tenant in debt blocks
  before its next backend read until the bucket refills — one hot tenant
  cannot starve the rest of disk/NIC service.
* **SLO-driven hedged reads** — ``hedge="slo"`` derives the duplicate-fetch
  delay from the live backend-latency distribution against the p99 target
  (fire at ``max(hedge_min_s, slo_p99_s - p50)``, the latest moment a typical
  duplicate can still finish inside the SLO) instead of a fixed delay, with a
  sustained duplicate-rate budget.

With ``ServeSpec.autotune.enabled`` (``objective="latency"``) the path runs
an :class:`repro_torch.core.autotune.AutotuneController` fed per-request latencies:
the hedge delay, coalesce window, and (tiered-cache stacks) the cache knobs
hill-climb against the p99 target.  Every request records a ``serve_get``
tracing span.

The reference's read path.  It runs on the host only and imports no
``torch`` (the package's ``__init__`` imports the engine, which does).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.config import ServeSpec, TenantPolicy
from repro_torch.core.autotune import (
    AutotuneController,
    build_cache_knobs,
    build_serve_knobs,
)
from repro_torch.core.tracing import NULL_TRACER, SERVE_GET, Tracer

HEDGE_MODES = ("off", "fixed", "slo")

# a waiter woken by a failed flight re-enters the begin() race this many
# times (each round elects one new retry leader) before surfacing the error
_MAX_WAITER_RETRIES = 2


@dataclass
class ReadResult:
    """One served request.  ``source``: which mechanism produced the bytes —
    ``memory``/``disk`` (cache tier hit), ``coalesced`` (shared another
    request's backend fetch), or ``fetch`` (this request led its own)."""

    key: str
    data: bytes
    tenant: str
    source: str
    latency_s: float = 0.0
    hedged: bool = False
    throttled_s: float = 0.0  # time blocked on the tenant's byte budget


def _pctl(sorted_xs: List[float], q: float) -> float:
    if not sorted_xs:
        return 0.0
    return sorted_xs[min(int(len(sorted_xs) * q), len(sorted_xs) - 1)]


class _TokenBucket:
    """Post-paid byte budget: backend service *debits* the bucket (possibly
    into debt — an object's size is unknown until fetched), and a tenant in
    debt blocks before its NEXT backend read until refill clears the debt.
    The sustained rate is therefore enforced to within one object size of
    ``rate_bytes_per_s``, with ``burst`` bytes of slack for idle tenants."""

    def __init__(self, rate_bytes_per_s: float, burst_bytes: float,
                 clock: Callable[[], float], sleep: Callable[[float], None]) -> None:
        self.rate = float(rate_bytes_per_s)
        self.burst = float(burst_bytes) if burst_bytes > 0 else self.rate
        self._level = self.burst
        self._clock = clock
        self._sleep = sleep
        self._t = clock()
        self._lock = threading.Lock()
        self.charged_bytes = 0
        self.waited_s = 0.0

    @property
    def metered(self) -> bool:
        return self.rate > 0

    def _refill_locked(self) -> None:
        now = self._clock()
        self._level = min(self.burst, self._level + (now - self._t) * self.rate)
        self._t = now

    def level(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._level

    def charge(self, nbytes: int) -> None:
        if not self.metered:
            return
        with self._lock:
            self._refill_locked()
            self._level -= nbytes
            self.charged_bytes += nbytes

    def wait_for_credit(self, timeout: Optional[float] = None) -> float:
        """Block until the bucket is out of debt (level > 0); returns the
        seconds waited.  Refill is purely time-based, so the wait sleeps the
        computed deficit directly (chunked to stay timeout-responsive)."""
        if not self.metered:
            return 0.0
        t0 = self._clock()
        deadline = None if timeout is None else t0 + timeout
        while True:
            with self._lock:
                self._refill_locked()
                if self._level > 0:
                    break
                need = -self._level / self.rate + 1e-4
            now = self._clock()
            if deadline is not None:
                if now >= deadline:
                    break
                need = min(need, deadline - now)
            self._sleep(min(need, 0.25))
        waited = self._clock() - t0
        with self._lock:
            self.waited_s += waited
        return waited


class _Flight:
    __slots__ = ("done", "data", "error", "t_start", "t_done")

    def __init__(self, now: float) -> None:
        self.done = threading.Event()
        self.data: Optional[bytes] = None
        self.error: Optional[BaseException] = None
        self.t_start = now
        self.t_done = 0.0


class _SingleFlight:
    """Per-key flight table: at most one in-flight backend fetch per key;
    concurrent misses join the leader's flight and share its bytes.  A
    completed flight is HELD for the coalesce window (so a burst arriving
    just after completion still coalesces); a failed flight is dropped
    immediately and wakes every waiter — the first to re-enter ``begin``
    becomes the retry leader, the rest re-wait on the new flight."""

    def __init__(self, window_fn: Callable[[], float],
                 clock: Callable[[], float]) -> None:
        self._window_fn = window_fn  # live: the coalesce window is a knob
        self._clock = clock
        self._lock = threading.Lock()
        self._flights: Dict[str, _Flight] = {}
        self._begins = 0

    def begin(self, key: str) -> Tuple[_Flight, bool]:
        """Returns ``(flight, is_leader)``."""
        now = self._clock()
        with self._lock:
            self._begins += 1
            if self._begins % 256 == 0:
                self._prune_locked(now)
            fl = self._flights.get(key)
            if fl is not None:
                if not fl.done.is_set():
                    return fl, False  # join the in-flight fetch
                if fl.error is None and now - fl.t_done <= self._window_fn():
                    return fl, False  # completed result still held
            nf = _Flight(now)
            self._flights[key] = nf
            return nf, True

    def finish(self, key: str, flight: _Flight, data: Optional[bytes] = None,
               error: Optional[BaseException] = None) -> None:
        with self._lock:
            flight.data = data
            flight.error = error
            flight.t_done = self._clock()
            if error is not None and self._flights.get(key) is flight:
                del self._flights[key]
        flight.done.set()

    def held(self) -> int:
        with self._lock:
            return len(self._flights)

    def _prune_locked(self, now: float) -> None:
        window = self._window_fn()
        stale = [
            k for k, fl in self._flights.items()
            if fl.done.is_set() and now - fl.t_done > window
        ]
        for k in stale:
            del self._flights[k]


class _Hedger:
    """Duplicate-fetch policy.  ``fixed`` fires after a constant delay;
    ``slo`` derives the delay from the live backend-latency distribution
    against the tail target — fire at ``max(hedge_min_s, slo_p99_s - p50)``,
    the latest moment a typical duplicate can still finish inside the SLO.
    Most fetches complete before the derived delay, so only true stragglers
    pay for a duplicate, and ``hedge_budget_fraction`` bounds the sustained
    duplicate rate regardless of the delay."""

    CALIBRATION_SAMPLES = 16

    def __init__(self, spec: ServeSpec) -> None:
        self.mode = spec.hedge
        self._fixed = spec.hedge_delay_s
        self._floor = spec.hedge_min_s
        self._slo = spec.slo_p99_s
        self._budget = spec.hedge_budget_fraction
        self._durs: Deque[float] = deque(maxlen=256)
        self._lock = threading.Lock()
        self.requests = 0
        self.issued = 0
        self.won = 0
        self.delay_override_s = 0.0  # autotune knob; 0 = policy-derived

    def note_request(self) -> None:
        with self._lock:
            self.requests += 1

    def observe(self, dur_s: float) -> None:
        with self._lock:
            self._durs.append(dur_s)

    def delay(self) -> Optional[float]:
        """Seconds to wait before duplicating, or None (don't hedge)."""
        if self.mode == "off":
            return None
        if self.delay_override_s > 0:
            return self.delay_override_s
        if self.mode == "fixed":
            return self._fixed
        with self._lock:
            durs = sorted(self._durs)
        if len(durs) < self.CALIBRATION_SAMPLES:
            return None  # calibrating: no hedges until p50 is known
        p50 = durs[len(durs) // 2]
        return max(self._floor, self._slo - p50)

    def allow(self) -> bool:
        """One combined budget check + issue count (atomic under the lock)."""
        if self._budget <= 0:
            return False
        with self._lock:
            if self.issued >= self._budget * max(self.requests, 1):
                return False
            self.issued += 1
            return True

    def record_win(self) -> None:
        with self._lock:
            self.won += 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "mode": self.mode,
                "requests": self.requests,
                "issued": self.issued,
                "won": self.won,
                "delay_s": self.delay_override_s or None,
            }


class _Tenant:
    __slots__ = ("name", "policy", "bucket", "sem", "lock", "requests",
                 "by_source", "backend_bytes", "lat")

    def __init__(self, name: str, policy: TenantPolicy,
                 clock: Callable[[], float],
                 sleep: Callable[[float], None]) -> None:
        self.name = name
        self.policy = policy
        self.bucket = _TokenBucket(
            policy.rate_bytes_per_s, float(policy.burst_bytes), clock, sleep
        )
        self.sem = (
            threading.BoundedSemaphore(policy.max_inflight)
            if policy.max_inflight > 0 else None
        )
        self.lock = threading.Lock()
        self.requests = 0
        self.by_source = {"memory": 0, "disk": 0, "coalesced": 0, "fetch": 0}
        self.backend_bytes = 0
        self.lat: Deque[float] = deque(maxlen=8192)


class ReadPath:
    """Multi-tenant GET front end over any ``ObjectStore``-shaped store.

    When the store is a :class:`repro_torch.data.cache.TieredCacheStore` its
    cache-only ``lookup`` serves memory/disk hits without entering
    single-flight, so coalescing and metering apply exactly to the requests
    that cost backend service.  ``clock``/``sleep`` are injectable for
    deterministic tests."""

    def __init__(self, store: Any, spec: Optional[ServeSpec] = None, *,
                 tracer: Tracer = NULL_TRACER,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        spec = spec if spec is not None else ServeSpec()
        if spec.hedge not in HEDGE_MODES:
            raise ValueError(
                f"unknown hedge mode {spec.hedge!r}; known: {HEDGE_MODES}"
            )
        self.store = store
        self.spec = spec
        self.tracer = tracer
        self._clock = clock
        self._sleep = sleep
        self._window_s = float(spec.coalesce_window_s)
        self._sf = _SingleFlight(lambda: self._window_s, clock)
        self._hedger = _Hedger(spec)
        pool_width = spec.max_inflight if spec.max_inflight > 0 else 64
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, min(pool_width, 256)),
            thread_name_prefix="readpath",
        )
        self._gate = (
            threading.BoundedSemaphore(spec.max_inflight)
            if spec.max_inflight > 0 else None
        )
        self._policies = {p.tenant: p for p in spec.tenants}
        self._default_policy = self._policies.get("*", TenantPolicy())
        self._tenants: Dict[str, _Tenant] = {}
        self._tlock = threading.Lock()
        # single-flight audit: primary (non-hedge) backend fetch start times
        # per key — benchmarks assert <= 1 start per key per coalesce window
        self._audit_lock = threading.Lock()
        self._fetch_log: Dict[str, List[float]] = {}
        self._hedge_log: Dict[str, int] = {}
        self._closed = False
        # latency-objective closed-loop control
        self.autotuner: Optional[AutotuneController] = None
        self._at_lock = threading.Lock()
        at = spec.autotune
        if at.enabled:
            if at.objective != "latency":
                raise ValueError(
                    "ReadPath autotuning scores request latencies: set"
                    ' ServeSpec.autotune.objective="latency"'
                )
            knobs = build_serve_knobs(at, self)
            if at.tune_cache and hasattr(store, "cache_stats"):
                knobs += build_cache_knobs(at, store)
            self.autotuner = AutotuneController(at, knobs, tracer=tracer)

    # -- autotune knob surfaces (milliseconds: the controller is integer) ----
    @property
    def hedge_mode(self) -> str:
        return self._hedger.mode

    def hedge_delay_ms(self) -> int:
        d = (self._hedger.delay_override_s or self._hedger.delay()
             or self.spec.hedge_delay_s)
        return max(1, int(round(d * 1000)))

    def set_hedge_delay_ms(self, v: int) -> int:
        v = max(1, int(v))
        self._hedger.delay_override_s = v / 1000.0
        return v

    def coalesce_ms(self) -> int:
        return int(round(self._window_s * 1000))

    def set_coalesce_ms(self, v: int) -> int:
        v = max(1, int(v))
        self._window_s = v / 1000.0
        return v

    # -- request surface -----------------------------------------------------
    def get(self, key: str, tenant: str = "default",
            timeout: Optional[float] = None) -> ReadResult:
        if self._closed:
            raise RuntimeError("ReadPath is closed")
        t0 = self._clock()
        ten = self._tenant(tenant)
        self._hedger.note_request()
        res = self._serve(key, ten, timeout)
        end = self._clock()
        res.latency_s = end - t0
        self.tracer.record(
            SERVE_GET, t0, end, tenant=ten.name, source=res.source,
            hedged=res.hedged, nbytes=len(res.data),
        )
        with ten.lock:
            ten.requests += 1
            ten.by_source[res.source] += 1
            ten.lat.append(res.latency_s)
        if self.autotuner is not None:
            # serialize: the controller's state machine is single-threaded
            with self._at_lock:
                self.autotuner.on_request(res.latency_s, now=end)
        return res

    def _tenant(self, name: str) -> _Tenant:
        with self._tlock:
            ten = self._tenants.get(name)
            if ten is None:
                pol = self._policies.get(name, self._default_policy)
                ten = _Tenant(name, pol, self._clock, self._sleep)
                self._tenants[name] = ten
            return ten

    def _serve(self, key: str, ten: _Tenant,
               timeout: Optional[float]) -> ReadResult:
        # 1. cache tiers.  Memory hits are free (no shared-resource
        # contention); disk service debits the tenant's budget but never
        # blocks — accumulated debt gates the tenant's NEXT backend read.
        peek = getattr(self.store, "lookup", None)
        if peek is not None:
            hit = peek(key)
            if hit is not None:
                data, tier = hit
                if tier == "disk":
                    ten.bucket.charge(len(data))
                return ReadResult(key, data, ten.name, tier)
        # 2. miss: the backend fetch path
        if self._window_s <= 0:
            # coalescing disabled (the uncoalesced baseline): every miss
            # fetches independently
            waited = ten.bucket.wait_for_credit(timeout)
            data, hedged = self._fetch(key, ten)
            return ReadResult(key, data, ten.name, "fetch",
                              hedged=hedged, throttled_s=waited)
        retries = 0
        while True:
            fl, leader = self._sf.begin(key)
            if leader:
                # fairness gates the LEADER only — waiters piling onto this
                # flight consume no extra backend service, and a throttled
                # tenant's followers queue behind its leader's credit wait
                waited = ten.bucket.wait_for_credit(timeout)
                try:
                    data, hedged = self._fetch(key, ten)
                except BaseException as e:
                    self._sf.finish(key, fl, error=e)
                    raise
                self._sf.finish(key, fl, data=data)
                return ReadResult(key, data, ten.name, "fetch",
                                  hedged=hedged, throttled_s=waited)
            if not fl.done.wait(timeout):
                raise TimeoutError(
                    f"coalesced read of {key!r} timed out after {timeout}s"
                )
            if fl.error is None:
                assert fl.data is not None
                return ReadResult(key, fl.data, ten.name, "coalesced")
            # the leader's fetch crashed: every waiter lands here and
            # re-enters begin() — the race elects exactly one retry leader,
            # the rest re-wait on the new flight
            retries += 1
            if retries > _MAX_WAITER_RETRIES:
                raise fl.error

    def _fetch(self, key: str, ten: _Tenant) -> Tuple[bytes, bool]:
        """One backend fetch (possibly hedged), audited and metered."""
        t0 = self._clock()
        with self._audit_lock:
            log = self._fetch_log.setdefault(key, [])
            log.append(t0)
            if len(log) > 4096:
                del log[0]
        if ten.sem is not None:
            ten.sem.acquire()
        if self._gate is not None:
            self._gate.acquire()
        try:
            delay = self._hedger.delay()
            if delay is None:
                data, hedged = self.store.get(key), False
            else:
                data, hedged = self._hedged_fetch(key, delay)
        finally:
            if self._gate is not None:
                self._gate.release()
            if ten.sem is not None:
                ten.sem.release()
        self._hedger.observe(self._clock() - t0)
        ten.bucket.charge(len(data))
        with ten.lock:
            ten.backend_bytes += len(data)
        return data, hedged

    def _hedged_fetch(self, key: str, delay: float) -> Tuple[bytes, bool]:
        primary = self._pool.submit(self.store.get, key)
        done, _ = wait({primary}, timeout=delay)
        if done or not self._hedger.allow():
            return primary.result(), False
        with self._audit_lock:
            self._hedge_log[key] = self._hedge_log.get(key, 0) + 1
        backup = self._pool.submit(self.store.get, key)
        pending = {primary, backup}
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                if f.exception() is None:
                    if f is backup:
                        self._hedger.record_win()
                    return f.result(), True
            # the finisher errored: fall through to whichever copy remains
        return primary.result(), True  # both failed — surface the primary's

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        tenants: Dict[str, Any] = {}
        with self._tlock:
            items = list(self._tenants.items())
        for name, ten in items:
            with ten.lock:
                lat = sorted(ten.lat)
                tenants[name] = {
                    "requests": ten.requests,
                    "by_source": dict(ten.by_source),
                    "backend_bytes": ten.backend_bytes,
                    "throttle_wait_s": round(ten.bucket.waited_s, 6),
                    "p50_s": _pctl(lat, 0.50),
                    "p99_s": _pctl(lat, 0.99),
                }
        return {
            "tenants": tenants,
            "hedge": self._hedger.stats(),
            "coalesce_window_s": self._window_s,
            "flights_held": self._sf.held(),
        }

    def audit_fetches(self) -> Dict[str, List[float]]:
        """Per-key primary (non-hedge) backend fetch start times."""
        with self._audit_lock:
            return {k: list(v) for k, v in self._fetch_log.items()}

    def audit_hedges(self) -> Dict[str, int]:
        with self._audit_lock:
            return dict(self._hedge_log)

    def audit_max_fetches_per_window(
            self, window_s: Optional[float] = None) -> int:
        """Worst case over keys: the max number of primary backend fetch
        starts inside any sliding window of ``window_s`` (default: the
        coalesce window).  A healthy coalescing path reports <= 1 — a
        completed flight is held for the window, so consecutive fetch starts
        for one key are strictly more than a window apart."""
        w = self._window_s if window_s is None else window_s
        worst = 0
        for times in self.audit_fetches().values():
            times.sort()
            j = 0
            for i in range(len(times)):
                while times[i] - times[j] > w:
                    j += 1
                worst = max(worst, i - j + 1)
        return worst

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "ReadPath":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
