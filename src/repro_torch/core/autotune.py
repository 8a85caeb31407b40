"""Online loader autotuning — closed-loop version of the paper's Fig. 10/11 grid.

The paper finds the best (workers x fetchers x prefetch) point by *offline*
grid search per storage backend; the optimum moves with storage latency,
object size and contention, so a loader has to find it *online*.
:class:`AutotuneController` is a hill-climbing feedback controller with
hysteresis that consumes live signals the stack already produces (windowed
throughput of delivered batches, per-stage latency aggregates from
:func:`repro_torch.core.tracing.window_summary`, store statistics) and
adjusts loader knobs at the safe between-batch boundary: per-worker fetch
concurrency (``Fetcher.resize``), the prefetch outstanding window, the
staged pipeline's stage widths, queue depth and reorder window, hedged
requests on/off (``HedgeTracker.enabled``), and the ``DevicePrefetchRing``
depth when a ring is attached.  It only sees :class:`Knob` callbacks, so the
tests drive it against synthetic throughput profiles.

Algorithm: coordinate hill climbing with a multiplicative step, a
hysteresis dead-band, and a *settle window* between move and verdict.
Every ``interval_batches`` batches one window of throughput is measured.
After a knob move the next window is discarded (in-flight batches
dispatched under the old setting drain through it), and the window after
that is compared to the pre-probe baseline: *accepted* when it beats the
baseline by ``rel_improvement`` (momentum: the same knob is pushed again),
*reverted* when it regresses by the same margin (direction flips, then
settle + fresh baseline), and otherwise *held* (keep the value, move to the
next knob).  Concurrency-reducing moves need twice the improvement.  The
controller remembers the best *settled* operating point; a collapse below
half of it restores that point wholesale.  After ``patience`` full knob
cycles without an accepted move it restores the best state and goes
quiescent; a collapse below half of the best-seen throughput re-arms it,
and a heartbeat re-probes every ``reprobe_windows`` quiescent windows.

Multi-host cooperation, as the reference's: with a ``probe_lease``
(:class:`~repro_torch.core.coord.UpProbeLease`, wired from
``AutotuneConfig.coord_dir``) every upward probe first takes the fleet-wide
up-probe token, renews it across the probe's windows (a lost renewal aborts
the probe) and hands it back on revert, hold, quiesce, a downward move, a
rebind and :meth:`AutotuneController.release_coordination`.  With a
``congestion`` board (:class:`~repro_torch.core.coord.CongestionBoard`,
``shed_collapse_fraction > 0``) a collapse posts a fleet-wide shed, and
every controller cuts its multiplicative knobs and climbs back additively.
:func:`build_cache_knobs` turns a tiered cache's capacities and admission
policy into knobs, :func:`build_serve_knobs` the serving read path's hedge
delay and coalesce window; with ``objective="latency"`` the read path feeds
:meth:`AutotuneController.on_request` and the controller minimizes the tail
latency through the same hill climber.  The shm transport's usable slots a
slab ride along the pipeline's knobs.

With a ``skew_fn`` (the sharded delivery lanes' composed-batch
divergence, wired by the loader when ``AutotuneConfig.skew_gate`` is set)
upward probes are skipped while the lanes have diverged, as in the
reference.  The reference gives the same events as this controller, except
where an
additive knob (the thread budget's split, the cache admission index) sits
at its upper wall: the reference never probes it down from there (ROADMAP
§3).  The module imports no ``torch``: the staged pipeline imports it, and
``spawn`` re-imports the pipeline in every CPU worker process.
"""
from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.config import AutotuneConfig
from repro_torch.core.tracing import (
    GET_BATCH,
    GET_ITEM,
    StageWindow,
    Tracer,
    window_summary,
)

LOAD_BATCH = "load_batch"  # mirror of worker.LOAD_BATCH (import cycle-free)

# re-arm when windowed throughput falls below this fraction of best-seen
REARM_FRACTION = 0.5


@dataclass
class Knob:
    """One tunable integer control surface.

    ``set`` must apply the value at a safe boundary and return the value
    actually applied (clamped by the owner); binary knobs use ``lo=0, hi=1``.
    ``scale`` selects multiplicative stepping (concurrency/capacity knobs) or
    additive stepping (the budget split).  ``step_schedule`` overrides the
    config's coarse->fine factors for this knob.
    """

    name: str
    get: Callable[[], int]
    set: Callable[[int], int]
    lo: int
    hi: int
    scale: str = "mult"  # mult | add
    step_schedule: Tuple[int, ...] = field(default=())

    @property
    def is_binary(self) -> bool:
        return (self.lo, self.hi) == (0, 1)


@dataclass(frozen=True)
class TuneEvent:
    """One controller decision (the audit trail tests and runs read)."""

    batch: int
    action: str  # probe | accept | revert | hold | restore | quiesce | rearm
    #             | reprobe | gate (up-move skipped: accelerator saturated)
    #             | lease (up-move skipped: a peer holds the up-probe token)
    #             | skew (up-move skipped: delivery lanes diverged)
    #             | entropy (reorder-window up-move skipped: shuffle floor)
    #             | shed (local collapse: posted + multiplicative cut)
    #             | shed_peer (a peer's shed event honored: multiplicative cut)
    #             | recover (one additive step back toward pre-shed values)
    knob: str
    value: int
    tput: float


@dataclass
class _Probe:
    knob: Knob
    old_value: int
    new_value: int
    baseline: float


class AutotuneController:
    """Hill-climbing knob controller; drive with :meth:`on_batch`."""

    def __init__(
        self,
        cfg: AutotuneConfig,
        knobs: List[Knob],
        *,
        tracer: Optional[Tracer] = None,
        store_stats_fn: Optional[Callable[[], Any]] = None,
        util_fn: Optional[Callable[[], Optional[float]]] = None,
        probe_lease: Optional[Any] = None,
        skew_fn: Optional[Callable[[], Optional[float]]] = None,
        entropy_fn: Optional[Callable[[], Optional[float]]] = None,
        congestion: Optional[Any] = None,
    ) -> None:
        if cfg.objective not in ("throughput", "latency"):
            raise ValueError(
                f"unknown autotune objective {cfg.objective!r};"
                " known: 'throughput', 'latency'"
            )
        self.cfg = cfg
        self.knobs = list(knobs)
        self.tracer = tracer
        self.store_stats_fn = store_stats_fn
        # fleet-wide up-probe token (UpProbeLease-shaped); None = single
        # host, no coordination anywhere
        self.probe_lease = probe_lease
        self._lease_held = False
        # accelerator busy-fraction signal (None = no signal yet); wired by
        # the trainer so the controller stops buying loader throughput the
        # training step can't eat (see cfg.util_gate)
        self.util_fn = util_fn
        # sharded-delivery lane-skew signal (None = no signal): when the
        # lanes' composed-batch counts diverge past cfg.skew_gate, upward
        # probes are skipped (see _start_probe)
        self.skew_fn = skew_fn
        # shuffle-entropy signal (None = no signal): below
        # cfg.min_shuffle_entropy, upward probes of the reorder_window knob
        # are skipped
        self.entropy_fn = entropy_fn
        # latency-objective window (on_request): per-request latencies whose
        # tail quantile is inverted into the hill climber's score
        self._lat_window: List[float] = []
        # bounded: the reprobe heartbeat keeps appending for the loader's
        # lifetime; consumers only ever need the recent tail
        self.events: Deque[TuneEvent] = deque(maxlen=4096)

        self._batches = 0
        self._win_batches = 0
        self._win_items = 0
        self._windows_seen = 0
        self._win_t0: Optional[float] = None
        self._probe: Optional[_Probe] = None
        # measurement state machine: baseline -> (probe applied) settle ->
        # measure -> {accept/hold: settle, revert: settle_revert -> baseline}
        self._phase = "baseline"
        self._ki = 0  # round-robin knob cursor
        self._dir: Dict[str, int] = {k.name: +1 for k in self.knobs}
        # per-knob position in the coarse->fine step schedule
        self._step_idx: Dict[str, int] = {k.name: 0 for k in self.knobs}
        self._stalled_moves = 0  # consecutive non-accepted probes
        self._quiescent = False
        self._quiet_windows = 0  # windows spent quiescent (reprobe heartbeat)
        self._best_tput = 0.0
        # best *settled* operating point seen: (knob values, its throughput)
        self._best_state: Dict[str, int] = {}
        self._best_state_tput = 0.0
        # cooperative AIMD down-shedding (CongestionBoard-shaped; None =
        # off).  On a shed, ours or a peer's, every multiplicative knob is
        # cut and then climbs back additively toward its pre-shed value:
        # _shed_target holds the goals, _shed_step_sz each knob's increment,
        # _shed_hold the windows left to sit at the cut point.
        self.congestion = congestion
        self._shed_seq = 0
        if congestion is not None:
            try:
                # start from the board's tip: older shed events predate
                # this controller and must not trigger a cut now
                self._shed_seq = congestion.last_seq()
            except OSError:
                self._shed_seq = 0
        self._shed_target: Dict[str, int] = {}
        self._shed_step_sz: Dict[str, int] = {}
        self._shed_hold = 0

    # -- public surface ------------------------------------------------------

    def bind(self, knobs: List[Knob]) -> None:
        """Re-bind knob callbacks (a new iterator each epoch) while keeping
        learned state: per-knob direction, quiescence, best-seen throughput.
        Any in-flight probe is dropped: it refers to the old iterator."""
        self.knobs = list(knobs)
        for k in knobs:
            self._dir.setdefault(k.name, +1)
            self._step_idx.setdefault(k.name, 0)
        # start the new epoch at the best point measured so far, not at
        # whatever mid-probe value the last iterator stopped on
        for k in self.knobs:
            if k.name in self._best_state:
                k.set(self._best_state[k.name])
        self._probe = None
        self._release_lease()  # the dropped probe may have held the token
        self._phase = "baseline"
        self._win_t0 = None
        self._win_batches = 0
        self._win_items = 0
        self._windows_seen = 0  # re-warm: each iterator has its own burst
        self._ki = min(self._ki, max(len(self.knobs) - 1, 0))

    def attach_knob(self, knob: Knob) -> None:
        """Add a knob live (e.g. ring depth once a DevicePrefetchRing exists).

        A knob seen in a previous epoch re-attaches silently: its learned
        value is re-applied and a quiescent controller stays quiescent; only
        a genuinely NEW control surface re-arms probing."""
        self.knobs.append(knob)
        seen = knob.name in self._dir
        self._dir.setdefault(knob.name, +1)
        self._step_idx.setdefault(knob.name, 0)
        if knob.name in self._best_state:
            knob.set(self._best_state[knob.name])
        if not seen:
            self._quiescent = False
            self._stalled_moves = 0

    def attach_ring(self, ring: Any) -> None:
        """Tune an attached :class:`DevicePrefetchRing`'s depth."""
        self.attach_knob(
            Knob(
                name="device_prefetch",
                get=lambda: ring.depth,
                set=ring.set_depth,
                lo=self.cfg.min_device_prefetch,
                hi=min(self.cfg.max_device_prefetch, ring.max_depth),
            )
        )

    def reset_window(self) -> None:
        """Drop the in-flight measurement window and any probe riding on it;
        call before resuming ``on_batch`` after a feeding pause (the gap
        would otherwise be measured as a throughput collapse).  The probed
        knob value is kept; only the judgment is abandoned."""
        self._win_t0 = None
        self._win_batches = 0
        self._win_items = 0
        self._probe = None
        self._release_lease()
        if self._phase in ("settle", "measure"):
            self._phase = "baseline"

    def on_batch(self, items: int = 1, now: Optional[float] = None) -> None:
        """Account one delivered batch; maybe close a window and adjust."""
        t = time.monotonic() if now is None else now
        if self._win_t0 is None:
            self._win_t0 = t
            return  # first batch only anchors the window clock
        self._batches += 1
        self._win_batches += 1
        self._win_items += items
        if (
            self._win_batches < self.cfg.interval_batches
            or t - self._win_t0 < self.cfg.min_window_s
        ):
            return
        dt = max(t - self._win_t0, 1e-9)
        tput = self._win_items / dt
        self._win_t0 = t
        self._win_batches = 0
        self._win_items = 0
        self._step(tput)

    def on_request(self, latency_s: float, now: Optional[float] = None) -> None:
        """Account one served request (``objective="latency"``): windows
        per-request latencies and feeds the unchanged hill climber an
        inverted tail score, ``latency_target_s / latency_quantile``, so the
        same maximizer (probe, judge, hysteresis, quiesce) MINIMIZES the
        tail against the SLO target.  Size ``interval_batches`` to hold
        enough requests for the quantile to mean something (at least 200
        for a p99)."""
        t = time.monotonic() if now is None else now
        self._lat_window.append(latency_s)
        if self._win_t0 is None:
            self._win_t0 = t
            return  # the first request only anchors the window clock
        self._batches += 1
        self._win_batches += 1
        if (
            self._win_batches < self.cfg.interval_batches
            or t - self._win_t0 < self.cfg.min_window_s
        ):
            return
        lat = sorted(self._lat_window)
        self._lat_window.clear()
        q = lat[min(int(len(lat) * self.cfg.latency_quantile), len(lat) - 1)]
        self._win_t0 = t
        self._win_batches = 0
        self._win_items = 0
        self._step(self.cfg.latency_target_s / max(q, 1e-9))

    def diagnostics(self, window_s: float = 5.0) -> Dict[str, Any]:
        """Live signal snapshot (stage latencies + store stats)."""
        out: Dict[str, Any] = {
            "knobs": {k.name: k.get() for k in self.knobs},
            "best_tput": self._best_tput,
            "quiescent": self._quiescent,
        }
        if self.tracer is not None:
            now = time.monotonic()
            stages: Dict[str, StageWindow] = window_summary(
                self.tracer, [GET_BATCH, GET_ITEM, LOAD_BATCH], now - window_s, now
            )
            out["stages"] = {
                n: {"count": w.count, "mean_s": w.mean_s, "p95_s": w.p95_s}
                for n, w in stages.items()
            }
        if self.store_stats_fn is not None:
            try:
                out["store"] = self.store_stats_fn()
            except Exception:
                out["store"] = None
        return out

    def release_coordination(self) -> None:
        """Hand the fleet-wide up-probe token back (clean shutdown: peers
        should not have to wait out the crash TTL).  No-op without a lease."""
        self._release_lease()

    # -- cooperative lease ---------------------------------------------------

    def _lease_for_up(self) -> bool:
        """True when an upward probe may run: no lease configured, already
        holding (renewed), or the token was free to take.  A transient
        shared-dir error (NFS hiccup) counts as "token unavailable" rather
        than crashing the training loop — the controller just holds this
        window and retries next time."""
        if self.probe_lease is None:
            return True
        try:
            if self._lease_held:
                if self.probe_lease.renew():
                    return True
                self._lease_held = False  # TTL expired, a peer took over
            self._lease_held = bool(self.probe_lease.try_acquire())
        except OSError:
            self._lease_held = False
        return self._lease_held

    def _release_lease(self) -> None:
        if self.probe_lease is not None and self._lease_held:
            self._lease_held = False
            try:
                self.probe_lease.release()
            except OSError:  # pragma: no cover - shared dir unavailable
                pass

    # -- cooperative down-shedding (AIMD) ------------------------------------

    def _apply_shed(self, tput: float, action: str) -> None:
        """Multiplicative decrease: cancel any in-flight probe, hand the
        up-probe token back, and cut every scalable concurrency knob by
        ``shed_md_factor``, remembering the pre-shed values as additive
        recovery targets.  Binary and additive-scale knobs are left alone —
        halving a 0/1 toggle or an admission policy isn't "backing off"."""
        cfg = self.cfg
        if self._probe is not None:
            p, self._probe = self._probe, None
            p.knob.set(p.old_value)
        self._release_lease()
        n = 0
        for k in self.knobs:
            if k.is_binary or k.scale != "mult":
                continue
            cur = k.get()
            cut = max(k.lo, int(cur * cfg.shed_md_factor))
            if cut >= cur:
                continue
            k.set(cut)
            self._shed_target[k.name] = cur
            self._shed_step_sz[k.name] = max(
                1, -(-(cur - cut) // max(cfg.shed_recover_windows, 1))
            )
            n += 1
        self._shed_hold = max(cfg.shed_hold_windows, 0)
        self._phase = "baseline"
        self._log(action, "-", n, tput)

    def _shed_step(self, tput: float) -> bool:
        """AIMD coordination, run before normal hill climbing each window.
        Returns True when this window was consumed by shed/hold/recover —
        probing is suspended until additive recovery completes (climbing on
        top of a deliberate fleet-wide back-off would judge moves against a
        moving baseline AND defeat the back-off)."""
        if self.congestion is None:
            return False
        cfg = self.cfg
        try:
            seq, events = self.congestion.poll(self._shed_seq)
        except OSError:
            seq, events = self._shed_seq, []
        self._shed_seq = max(self._shed_seq, seq)
        if not self._shed_target:
            # a peer observed collapse: honor its shed event (our own posts
            # are consumed by the _shed_seq advance above, not re-applied)
            if any(e.get("h") != self.congestion.host for e in events):
                self._apply_shed(tput, "shed_peer")
                return True
            # local collapse: this settled window fell below the shed
            # fraction of our best settled throughput — post fleet-wide
            # (rate-limited under the board lock) and cut ourselves
            if (
                cfg.shed_collapse_fraction > 0
                and self._windows_seen > cfg.warmup_windows
                and self._best_state_tput > 0
                and tput < cfg.shed_collapse_fraction * self._best_state_tput
            ):
                try:
                    posted = self.congestion.post_shed(
                        tput, min_interval_s=cfg.shed_min_interval_s
                    )
                except OSError:
                    posted = None
                if posted is not None:
                    self._shed_seq = max(self._shed_seq, posted)
                self._apply_shed(tput, "shed")
                return True
            return False
        # shedding: hold at the cut point, then climb back additively.
        # Recovery only re-applies values this host already ran at, so it
        # deliberately does not contend for the up-probe lease.
        if self._shed_hold > 0:
            self._shed_hold -= 1
            return True
        done = True
        for k in self.knobs:
            tgt = self._shed_target.get(k.name)
            if tgt is None:
                continue
            cur = k.get()
            if cur >= tgt:
                continue
            nv = min(tgt, cur + self._shed_step_sz.get(k.name, 1))
            k.set(nv)
            self._log("recover", k.name, nv, tput)
            if nv < tgt:
                done = False
        if done:
            self._shed_target.clear()
            self._shed_step_sz.clear()
        return True

    # -- controller core -----------------------------------------------------

    def _log(self, action: str, knob: str, value: int, tput: float) -> None:
        self.events.append(TuneEvent(self._batches, action, knob, value, tput))

    def _step(self, tput: float) -> None:
        self._windows_seen += 1
        if self._shed_step(tput):
            return
        if self._lease_held and self._probe is not None:
            # keep the token alive across the settle+measure windows of an
            # in-flight upward probe (TTL is sized for a few windows only);
            # a transient shared-dir error counts as a lost token
            try:
                self._lease_held = bool(self.probe_lease.renew())
            except OSError:
                self._lease_held = False
            if not self._lease_held:
                # the TTL lapsed mid-probe and a peer may already hold the
                # token: letting our upward move keep running would be the
                # two-concurrent-up-probes state the lease exists to prevent
                # (and invisible to the lease audit).  Abort: roll the knob
                # back and re-baseline.
                p, self._probe = self._probe, None
                p.knob.set(p.old_value)
                self._log("revert", p.knob.name, p.old_value, tput)
                self._phase = "settle_revert"
                return
        if self._windows_seen <= self.cfg.warmup_windows:
            return  # settle: prefetch burst / startup warps early windows
        if self._phase == "settle":
            # batches dispatched under the pre-move setting drained through
            # this window: judging the probe on it mis-attributes them
            self._phase = "measure"
            return
        if self._phase == "settle_revert":
            self._phase = "baseline"
            return
        self._best_tput = max(self._best_tput, tput)
        self._note_state(tput)
        if self._phase == "measure" and self._probe is not None:
            self._judge(tput)
            return
        # baseline phase
        if not self._quiescent and self._restore_if_collapsed(tput):
            return
        if self._quiescent:
            # watch for a regime change (e.g. storage latency shift)
            if self._best_tput > 0 and tput < REARM_FRACTION * self._best_tput:
                self._quiescent = False
                self._stalled_moves = 0
                # decay (don't erase) the learned optimum: a transient stall
                # also lands here; repeated rearms decay it out of relevance
                self._best_tput = tput
                self._best_state_tput *= 0.5
                for name in self._dir:
                    self._dir[name] = +1
                # regime changed: the optimum may be far away, coarse again
                for name in self._step_idx:
                    self._step_idx[name] = 0
                self._log("rearm", "-", 0, tput)
                self._start_probe(tput)
                return
            # exploration heartbeat: parked-but-suboptimal is invisible to
            # the collapse check, so periodically try one move.  The stall
            # count is set so one failed probe re-quiesces.
            self._quiet_windows += 1
            if (
                self.cfg.reprobe_windows
                and self._quiet_windows >= self.cfg.reprobe_windows
            ):
                self._quiescent = False
                self._quiet_windows = 0
                self._stalled_moves = max(
                    0, self.cfg.patience * max(len(self.knobs), 1) - 1
                )
                for name in self._dir:
                    self._dir[name] = +1  # heartbeat explores upward
                self._log("reprobe", "-", 0, tput)
                self._start_probe(tput)
            return
        self._start_probe(tput)

    def _note_state(self, tput: float) -> None:
        """Remember the best settled operating point.  A new state must beat
        the incumbent by half the accept margin, so a noise-level
        'improvement' measured during a probe that is then reverted does
        not capture best-state."""
        margin = 1.0 + 0.5 * self.cfg.rel_improvement
        if not self._best_state or tput > self._best_state_tput * margin:
            self._best_state_tput = max(self._best_state_tput, tput)
            self._best_state = {k.name: k.get() for k in self.knobs}

    def _current_state(self) -> Dict[str, int]:
        return {k.name: k.get() for k in self.knobs}

    def _restore_best(self, tput: float) -> None:
        for k in self.knobs:
            if k.name in self._best_state:
                k.set(self._best_state[k.name])
        self._log("restore", "-", 0, tput)

    def _restore_if_collapsed(self, tput: float) -> bool:
        """A settled window far below the best state's throughput means the
        walk went downhill or the world changed: jump back to the best
        point wholesale instead of retracing the gradient."""
        if (
            self.cfg.collapse_restore
            and self._best_state
            and self._best_state_tput > 0
            and tput < REARM_FRACTION * self._best_state_tput
            and self._current_state() != self._best_state
        ):
            self._restore_best(tput)
            self._phase = "settle_revert"  # settle, then fresh baseline
            return True
        return False

    def _judge(self, tput: float) -> None:
        h = self.cfg.rel_improvement
        p, self._probe = self._probe, None
        went_down = p.new_value < p.old_value and not p.knob.is_binary
        if went_down:
            # concurrency-reducing move: demand stronger evidence
            h = 2.0 * h
        if tput >= p.baseline * (1.0 + h):
            self._log("accept", p.knob.name, p.new_value, tput)
            self._stalled_moves = 0
            if went_down or p.knob.is_binary:
                # keep the value, move to the next knob (a down-accept is
                # often a recovery artifact; a binary momentum step would
                # flip straight back)
                self._dir[p.knob.name] = +1
                self._advance()
                self._start_probe(tput)
                return
            # up-accept: keep pushing the same knob upward, with this
            # settled window as the new baseline
            self._start_probe(tput, prefer=p.knob)
            return
        if tput <= p.baseline * (1.0 - h) or p.knob.is_binary:
            # regression (or an unconvincing binary flip): roll back, then
            # settle + re-measure a clean baseline before the next probe
            p.knob.set(p.old_value)
            self._release_lease()  # the up-probe failed: let a peer try
            self._log("revert", p.knob.name, p.old_value, tput)
            self._refine(p.knob)  # the coarse jump overshot: step finer
            if not p.knob.is_binary:
                # a failed up-probe earns ONE down-trial; a failed down-probe
                # resets to climbing (never walk downhill repeatedly)
                self._dir[p.knob.name] = -1 if not went_down else +1
            self._advance()
            if self._bump_stall(tput):
                return
            self._phase = "settle_revert"
            return
        # dead-band: keep the value but stop pushing this knob
        self._release_lease()  # plateaued: the token helps a peer more
        self._log("hold", p.knob.name, p.new_value, tput)
        self._refine(p.knob)  # plateaued at this granularity: step finer
        if went_down:
            self._dir[p.knob.name] = +1
        self._advance()
        if self._bump_stall(tput):
            return
        self._start_probe(tput)

    def _bump_stall(self, tput: float) -> bool:
        self._stalled_moves += 1
        if self._stalled_moves >= self.cfg.patience * max(len(self.knobs), 1):
            self._quiescent = True
            self._quiet_windows = 0
            self._phase = "baseline"
            self._release_lease()
            # park at the best point ever measured, not wherever the walk
            # happened to stop
            if self._best_state and self._current_state() != self._best_state:
                self._restore_best(tput)
            self._log("quiesce", "-", 0, tput)
            return True
        return False

    def _advance(self) -> None:
        if self.knobs:
            self._ki = (self._ki + 1) % len(self.knobs)

    def _sched(self, knob: Knob) -> Tuple[int, ...]:
        """Coarse->fine step factors for this knob."""
        if knob.step_schedule:
            return knob.step_schedule
        if self.cfg.step_schedule:
            return self.cfg.step_schedule
        fine = max(self.cfg.step_factor, 2)
        return (2 * fine, fine)

    def _refine(self, knob: Knob) -> None:
        """Advance the knob's schedule to the next finer step (sticky at the
        finest); called when a probe at the current granularity didn't pay."""
        sched = self._sched(knob)
        idx = self._step_idx.get(knob.name, 0)
        self._step_idx[knob.name] = min(idx + 1, len(sched) - 1)

    def _next_value(self, knob: Knob, cur: int) -> Optional[int]:
        if knob.is_binary:
            return knob.hi - cur  # flip
        d = self._dir[knob.name]
        sched = self._sched(knob)
        step = sched[min(self._step_idx.get(knob.name, 0), len(sched) - 1)]
        if knob.scale == "add":
            step = max(step, 1)
            nxt = cur + step if d > 0 else cur - step
        else:
            step = max(step, 2)
            nxt = cur * step if d > 0 else cur // step
        nxt = max(knob.lo, min(knob.hi, nxt))
        return None if nxt == cur else nxt

    def _start_probe(self, baseline: float, prefer: Optional[Knob] = None) -> None:
        """Apply the next candidate move; scan knobs (preferred one first,
        then round-robin) until one can move.

        A knob pinned at its LOWER wall with a downward direction flips back
        up; a multiplicative knob at its UPPER wall is skipped (flipping there
        would momentum-probe a 4x drop right after reaching the top), while an
        additive one steps down by its schedule's step: skipped, a wall that
        an up-probe reached and held (or that was accepted on a window still
        draining the old setting's work) would never be left.  While the
        utilization gate is active, upward moves and binary trials are
        skipped (they would buy throughput nobody eats); downward moves
        still run, and likewise while the delivery lanes have diverged
        (``skew_gate``).  Reorder-window up-moves are skipped below the shuffle
        entropy floor.  With a ``probe_lease``, upward moves and binary
        trials also need the fleet-wide up-probe token: a peer holding it
        means the shared NIC is already being probed, so this host holds or
        refines downward until the token frees up."""
        if not self.knobs:
            return
        gated = self._util_gated()
        skewed = self._skew_gated()
        order: List[Knob] = []
        if prefer is not None:
            order.append(prefer)
            self._ki = self.knobs.index(prefer)
        for i in range(len(self.knobs)):
            k = self.knobs[(self._ki + i) % len(self.knobs)]
            if k is not prefer:
                order.append(k)
        skipped_for_gate = False
        skipped_for_skew = False
        skipped_for_lease = False
        skipped_for_entropy = False
        for k in order:
            cur = k.get()
            nxt = self._next_value(k, cur)
            if nxt is None and not k.is_binary and self._dir[k.name] < 0:
                # pinned at the lower wall pointing down: climb instead
                self._dir[k.name] = +1
                nxt = self._next_value(k, cur)
            elif nxt is None and k.scale == "add" and self._dir[k.name] > 0:
                # an additive knob pinned at its upper wall pointing up
                self._dir[k.name] = -1
                nxt = self._next_value(k, cur)
            if nxt is None:
                continue
            up_move = k.is_binary or nxt > cur
            if gated and up_move:
                skipped_for_gate = True
                continue
            if skewed and up_move:
                # the lanes have diverged: more width feeds the fast lanes
                # and deepens the imbalance; only downward refinement runs
                # until they re-converge
                skipped_for_skew = True
                continue
            if k.name == "reorder_window" and up_move and self._entropy_gated():
                skipped_for_entropy = True
                continue
            if up_move and not self._lease_for_up():
                skipped_for_lease = True
                continue
            applied = k.set(nxt)
            if applied == cur:
                continue  # owner clamped the move away: not a probe
            if not up_move:
                # refining downward: hand the token back so a peer can climb
                self._release_lease()
            self._probe = _Probe(k, cur, applied, baseline)
            self._ki = self.knobs.index(k)
            self._phase = "settle"
            self._log("probe", k.name, applied, baseline)
            return
        if skipped_for_gate or skipped_for_skew or skipped_for_lease or skipped_for_entropy:
            # accelerator-bound, lane-skewed, entropy-floored, or a peer
            # holds the up-probe token: not converged, so stay armed and
            # re-check next window instead of quiescing.  An idle hold of the
            # token is released so peers can use it.
            self._release_lease()
            action = ("gate" if skipped_for_gate
                      else "skew" if skipped_for_skew
                      else "lease" if skipped_for_lease else "entropy")
            self._log(action, "-", 0, baseline)
            self._phase = "baseline"
            return
        # nothing movable anywhere (e.g. a coarse momentum-accept landed every
        # knob on a wall): park, and say so in the audit trail
        self._quiescent = True
        self._quiet_windows = 0
        self._phase = "baseline"
        self._release_lease()
        self._log("quiesce", "-", 0, baseline)

    def _util_gated(self) -> bool:
        if self.util_fn is None or self.cfg.util_gate <= 0:
            return False
        try:
            util = self.util_fn()
        except Exception:
            return False
        return util is not None and util >= self.cfg.util_gate

    def _skew_gated(self) -> bool:
        if self.skew_fn is None or self.cfg.skew_gate <= 0:
            return False
        try:
            skew = self.skew_fn()
        except Exception:
            return False
        return skew is not None and skew >= self.cfg.skew_gate

    def _entropy_gated(self) -> bool:
        if self.entropy_fn is None or self.cfg.min_shuffle_entropy <= 0.0:
            return False
        try:
            entropy = self.entropy_fn()
        except Exception:
            return False
        return entropy is not None and entropy < self.cfg.min_shuffle_entropy


def make_weak_knob_callbacks(owner: Any) -> Tuple[Callable, Callable]:
    """Build ``(wget, wset)`` adaptors that route knob callbacks to ``owner``
    through a weakref.

    The controller outlives every epoch's iterator; a strong closure over the
    iterator would pin an abandoned one (and its worker/stage threads) until
    the next ``bind()``.  ``wget(fn)`` / ``wset(fn)`` wrap ``fn(it)`` /
    ``fn(it, n)``; once the owner is collected, get reports 0 and set echoes
    the request, so nothing real moves."""
    ref = weakref.ref(owner)

    def wget(fn: Callable[[Any], int]) -> Callable[[], int]:
        return lambda: (lambda it: fn(it) if it is not None else 0)(ref())

    def wset(fn: Callable[[Any, int], int]) -> Callable[[int], int]:
        return lambda n: (
            lambda it: fn(it, n) if it is not None else int(n)
        )(ref())

    return wget, wset


def _hedge_knob(hedge: Any) -> Knob:
    def _get_hedge() -> int:
        return int(hedge.enabled)

    def _set_hedge(v: int) -> int:
        hedge.enabled = bool(v)
        return int(hedge.enabled)

    return Knob("hedge", _get_hedge, _set_hedge, 0, 1)


def _slab_knob(cfg: AutotuneConfig, get_slab: Callable[[], int],
               set_slab: Callable[[int], int], max_slab: Optional[int]) -> Knob:
    """The shm transport's usable-slot cap a worker slab: slab pressure
    traded against the pickle-fallback rate."""
    return Knob(
        name="slab_slots",
        get=get_slab,
        set=set_slab,
        lo=cfg.min_slab_slots,
        hi=min(cfg.max_slab_slots, max_slab or cfg.max_slab_slots),
    )


def build_loader_knobs(
    cfg: AutotuneConfig,
    *,
    get_fetch: Callable[[], int],
    set_fetch: Callable[[int], int],
    get_outstanding: Callable[[], int],
    set_outstanding: Callable[[int], int],
    hedge: Optional[Any] = None,
    max_fetch_workers: Optional[int] = None,
    max_outstanding: Optional[int] = None,
) -> List[Knob]:
    """Standard knob set for a legacy ``_LoaderIter`` (ring attached
    separately).  ``max_*`` widen the configured ceilings when the loader's
    static config already sits above them (enabling autotune must never
    cap it)."""
    knobs = [
        Knob(
            name="fetch_workers",
            get=get_fetch,
            set=set_fetch,
            lo=cfg.min_fetch_workers,
            hi=max(cfg.max_fetch_workers, max_fetch_workers or 0),
        ),
        Knob(
            name="outstanding",
            get=get_outstanding,
            set=set_outstanding,
            lo=cfg.min_outstanding,
            hi=max(cfg.max_outstanding, max_outstanding or 0),
        ),
    ]
    if cfg.tune_hedge and hedge is not None:
        knobs.append(_hedge_knob(hedge))
    return knobs


def build_pipeline_knobs(
    cfg: AutotuneConfig,
    *,
    get_io: Callable[[], int],
    set_io: Callable[[int], int],
    get_cpu: Callable[[], int],
    set_cpu: Callable[[int], int],
    get_outstanding: Callable[[], int],
    set_outstanding: Callable[[int], int],
    get_queue: Callable[[], int],
    set_queue: Callable[[int], int],
    hedge: Optional[Any] = None,
    max_io: Optional[int] = None,
    max_cpu: Optional[int] = None,
    max_outstanding: Optional[int] = None,
    max_queue: Optional[int] = None,
    get_reorder: Optional[Callable[[], int]] = None,
    set_reorder: Optional[Callable[[int], int]] = None,
    get_slab: Optional[Callable[[], int]] = None,
    set_slab: Optional[Callable[[int], int]] = None,
    max_slab: Optional[int] = None,
) -> List[Knob]:
    """Per-stage knob set for a staged-pipeline ``_PipelineIter``: IO
    executor width, CPU executor width, the outstanding sample window (in
    batches) and the fetch->decode queue depth, each stage tuned
    independently.  ``max_*`` widen the configured ceilings over the static
    config; IO workers share the ``min/max_fetch_workers`` bounds.
    ``get/set_slab`` (shm transport only) tune the usable-slot cap of each
    worker's slab."""
    knobs = [
        Knob(
            name="io_workers",
            get=get_io,
            set=set_io,
            lo=cfg.min_fetch_workers,
            hi=max(cfg.max_fetch_workers, max_io or 0),
        ),
        Knob(
            name="cpu_workers",
            get=get_cpu,
            set=set_cpu,
            lo=cfg.min_cpu_workers,
            hi=max(cfg.max_cpu_workers, max_cpu or 0),
        ),
        Knob(
            name="outstanding",
            get=get_outstanding,
            set=set_outstanding,
            lo=cfg.min_outstanding,
            hi=max(cfg.max_outstanding, max_outstanding or 0),
        ),
        Knob(
            name="stage_queue",
            get=get_queue,
            set=set_queue,
            lo=cfg.min_stage_queue,
            hi=max(cfg.max_stage_queue, max_queue or 0),
        ),
    ]
    if get_slab is not None and set_slab is not None:
        knobs.append(_slab_knob(cfg, get_slab, set_slab, max_slab))
    if cfg.tune_hedge and hedge is not None:
        knobs.append(_hedge_knob(hedge))
    if get_reorder is not None and set_reorder is not None:
        knobs.append(build_reorder_knob(cfg, get_reorder=get_reorder,
                                        set_reorder=set_reorder))
    return knobs


def build_reorder_knob(
    cfg: AutotuneConfig,
    *,
    get_reorder: Callable[[], int],
    set_reorder: Callable[[int], int],
) -> Knob:
    """Reorder-window knob (window-mode pipelines only): a wider window
    tolerates stragglers at the cost of completion-time stratified batches;
    its up-probes are gated by ``cfg.min_shuffle_entropy``."""
    return Knob(
        name="reorder_window",
        get=get_reorder,
        set=set_reorder,
        lo=max(1, cfg.min_reorder_window),
        hi=max(cfg.max_reorder_window, cfg.min_reorder_window, 1),
    )


def budget_split_schedule(budget: int) -> Tuple[int, ...]:
    """Coarse->fine ADDITIVE steps for the io/cpu split knob: a quarter of
    the budget at a time first, single threads last."""
    steps: List[int] = []
    for s in (budget // 4, budget // 8, 1):
        s = max(int(s), 1)
        if not steps or s < steps[-1]:
            steps.append(s)
    return tuple(steps)


def build_budget_knobs(
    cfg: AutotuneConfig,
    *,
    budget: int,
    lo_split: int,
    hi_split: int,
    get_split: Callable[[], int],
    set_split: Callable[[int], int],
    get_outstanding: Callable[[], int],
    set_outstanding: Callable[[int], int],
    get_queue: Callable[[], int],
    set_queue: Callable[[int], int],
    get_cpu_executor: Optional[Callable[[], int]] = None,
    set_cpu_executor: Optional[Callable[[int], int]] = None,
    hedge: Optional[Any] = None,
    max_outstanding: Optional[int] = None,
    max_queue: Optional[int] = None,
    get_reorder: Optional[Callable[[], int]] = None,
    set_reorder: Optional[Callable[[int], int]] = None,
    get_slab: Optional[Callable[[], int]] = None,
    set_slab: Optional[Callable[[int], int]] = None,
    max_slab: Optional[int] = None,
) -> List[Knob]:
    """Knob set for a budget co-tuned ``_PipelineIter``
    (``AutotuneConfig.thread_budget``): the ``io_workers`` / ``cpu_workers``
    knobs are REPLACED by one coupled ``io_cpu_split`` knob whose value is
    the IO width (the CPU width is ``budget - value``), stepped additively
    coarse->fine.  When the owner can swap its CPU stage between threads and
    spawned processes, the executor KIND rides along as a binary knob.
    Outstanding window, queue depth, the slab knob and hedging stay as in
    :func:`build_pipeline_knobs`."""
    knobs = [
        Knob(
            name="io_cpu_split",
            get=get_split,
            set=set_split,
            lo=lo_split,
            hi=hi_split,
            scale="add",
            step_schedule=budget_split_schedule(budget),
        ),
        Knob(
            name="outstanding",
            get=get_outstanding,
            set=set_outstanding,
            lo=cfg.min_outstanding,
            hi=max(cfg.max_outstanding, max_outstanding or 0),
        ),
        Knob(
            name="stage_queue",
            get=get_queue,
            set=set_queue,
            lo=cfg.min_stage_queue,
            hi=max(cfg.max_stage_queue, max_queue or 0),
        ),
    ]
    if (
        cfg.tune_cpu_executor
        and get_cpu_executor is not None
        and set_cpu_executor is not None
    ):
        knobs.append(
            Knob("cpu_executor", get_cpu_executor, set_cpu_executor, 0, 1)
        )
    if get_slab is not None and set_slab is not None:
        knobs.append(_slab_knob(cfg, get_slab, set_slab, max_slab))
    if cfg.tune_hedge and hedge is not None:
        knobs.append(_hedge_knob(hedge))
    if get_reorder is not None and set_reorder is not None:
        knobs.append(build_reorder_knob(cfg, get_reorder=get_reorder,
                                        set_reorder=set_reorder))
    return knobs


def build_serve_knobs(cfg: AutotuneConfig, path: Any) -> List[Knob]:
    """Knobs for a ``ReadPath``-shaped object (duck-typed so
    ``repro_torch.core`` never imports ``repro_torch.serve``) under the
    latency objective: the hedge delay and the single-flight coalesce
    result-hold window, both in milliseconds.  Each knob is attached only
    when the spec enables its mechanism: a knob over a disabled one is a
    no-op the controller would waste probe windows on.  Cache knobs
    (:func:`build_cache_knobs`) ride along separately when the store stack
    has a tiered cache."""
    knobs: List[Knob] = []
    if getattr(path, "hedge_mode", "off") != "off":
        knobs.append(
            Knob(
                name="hedge_delay_ms",
                get=path.hedge_delay_ms,
                set=path.set_hedge_delay_ms,
                lo=cfg.min_hedge_delay_ms,
                hi=cfg.max_hedge_delay_ms,
            )
        )
    get_coalesce = getattr(path, "coalesce_ms", None)
    if get_coalesce is not None and get_coalesce() > 0:
        knobs.append(
            Knob(
                name="coalesce_ms",
                get=path.coalesce_ms,
                set=path.set_coalesce_ms,
                lo=cfg.min_coalesce_ms,
                hi=cfg.max_coalesce_ms,
            )
        )
    return knobs


def build_cache_knobs(cfg: AutotuneConfig, cache: Any) -> List[Knob]:
    """Knobs for a ``TieredCacheStore``-shaped object (duck-typed so
    ``repro_torch.core`` never imports ``repro_torch.data``): memory
    capacity, disk capacity, and the disk admission-policy index.

    Capacity knobs are attached ONLY when the config names an explicit
    ceiling above the configured capacity (``max_*_cache_bytes``): growing a
    cache is almost always throughput-positive, so a default ceiling would
    silently walk a user-sized cache up to it — and without growth headroom
    the knob would start pinned at its upper wall, where the controller
    never probes a multiplicative knob, making it a silent no-op.  No
    ceiling, no knob.  The lower bound widens down to the configured capacity, mirroring
    the loader-knob rule that enabling autotune must never clamp an explicit
    static config.  An unbounded disk tier (capacity 0) gets no capacity
    knob — there is nothing to trade off.  The admission knob is attached
    whenever a disk tier exists (``tune_admission``).  The cache object
    outlives any ``_LoaderIter``, so these knobs are attached per-epoch via
    ``attach_knob`` and keep their learned values."""
    knobs: List[Knob] = []
    mem = getattr(cache, "memory", None)
    if mem is not None and cfg.max_memory_cache_bytes > mem.capacity:
        knobs.append(
            Knob(
                name="cache_mem_bytes",
                get=lambda m=mem: m.capacity,
                set=cache.set_memory_capacity,
                lo=min(cfg.min_memory_cache_bytes, mem.capacity),
                hi=cfg.max_memory_cache_bytes,
            )
        )
    disk = getattr(cache, "disk", None)
    # a journal-shared disk tier's capacity belongs to the fleet, not to one
    # host's hill climber: two hosts walking the same shared bound in
    # opposite directions would thrash every peer's working set.  The
    # (per-host) memory knob and admission knob remain tunable.
    disk_shared = disk is not None and getattr(disk, "journal", None) is not None
    if (
        disk is not None and not disk_shared
        and disk.capacity and cfg.max_disk_cache_bytes > disk.capacity
    ):
        knobs.append(
            Knob(
                name="cache_disk_bytes",
                get=lambda d=disk: d.capacity,
                set=cache.set_disk_capacity,
                lo=min(cfg.min_disk_cache_bytes, disk.capacity),
                hi=cfg.max_disk_cache_bytes,
            )
        )
    if disk is not None and cfg.tune_admission:
        kinds = getattr(cache, "ADMISSION_KINDS", ())
        if len(kinds) > 2:  # a 2-policy space would look binary to the controller
            knobs.append(
                Knob(
                    name="cache_admission",
                    get=cache.admission_index,
                    set=cache.set_admission,
                    lo=0,
                    hi=len(kinds) - 1,
                    scale="add",
                    step_schedule=(1,),
                )
            )
    return knobs
