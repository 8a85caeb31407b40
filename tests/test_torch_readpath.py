"""Twins of ``tests/test_readpath.py`` on the port: the serving read path
(``repro_torch.serve.readpath``: single-flight coalescing, tenant fairness,
SLO hedging), the autotuner's latency objective and ``make_read_path``.
The same cases and assertions with the imports pointed at ``repro_torch``
(the lane-skew gate and ``RunConfig`` came with sharded delivery).  Beyond
the twins, against the reference itself: the latency controller's events on
the same request stream (and the skew gate's, gated or not), a request
sequence's sources and tenant accounting on a fake clock, and the token
bucket's waits."""
import threading
import time
from dataclasses import replace

import pytest

pytest.importorskip("torch")

from repro.config import AutotuneConfig as JaxAutotuneConfig  # noqa: E402
from repro.config import ServeSpec as JaxServeSpec  # noqa: E402
from repro.config import TenantPolicy as JaxTenantPolicy  # noqa: E402
from repro.core.autotune import AutotuneController as JaxController  # noqa: E402
from repro.core.autotune import Knob as JaxKnob  # noqa: E402
from repro.serve.readpath import ReadPath as JaxReadPath  # noqa: E402
from repro.serve.readpath import _TokenBucket as JaxTokenBucket  # noqa: E402
from repro_torch.config import AutotuneConfig, ServeSpec, TenantPolicy  # noqa: E402
from repro_torch.core import make_read_path  # noqa: E402
from repro_torch.core.autotune import AutotuneController, Knob  # noqa: E402
from repro_torch.data.store import InMemoryStore  # noqa: E402
from repro_torch.serve import ReadPath  # noqa: E402
from repro_torch.serve.readpath import _TokenBucket  # noqa: E402


def _filled_store(keys, size=1000):
    base = InMemoryStore()
    for k in keys:
        base.put(k, bytes(size))
    return base


class CountingStore:
    """Counts GETs; optional per-call delay schedule (first call = index 0)."""

    def __init__(self, base, delay_s=0.0, delays=None):
        self.base = base
        self.calls = 0
        self.delay_s = delay_s
        self.delays = delays or {}
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            n = self.calls
            self.calls += 1
        time.sleep(self.delays.get(n, self.delay_s))
        return self.base.get(key)


class CrashingLeaderStore:
    """First GET blocks until released, then raises; later GETs succeed."""

    def __init__(self, base):
        self.base = base
        self.calls = 0
        self._lock = threading.Lock()
        self.first_started = threading.Event()
        self.release_first = threading.Event()

    def get(self, key):
        with self._lock:
            n = self.calls
            self.calls += 1
        if n == 0:
            self.first_started.set()
            assert self.release_first.wait(10)
            raise RuntimeError("leader crashed")
        return self.base.get(key)


# ---------------------------------------------------------------------------
# single-flight semantics
# ---------------------------------------------------------------------------


class TestSingleFlight:
    def test_n_concurrent_misses_one_backend_fetch(self):
        store = CountingStore(_filled_store(["k"]), delay_s=0.05)
        rp = ReadPath(store, ServeSpec(coalesce_window_s=0.5))
        results = []

        def worker():
            results.append(rp.get("k", tenant="t"))

        threads = [threading.Thread(target=worker) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rp.close()
        assert store.calls == 1
        assert len(results) == 24
        assert all(r.data == results[0].data for r in results)
        assert sum(r.source == "fetch" for r in results) == 1
        assert sum(r.source == "coalesced" for r in results) == 23
        assert rp.audit_max_fetches_per_window() <= 1

    def test_completed_result_held_for_window_then_refetched(self):
        store = CountingStore(_filled_store(["k"]))
        rp = ReadPath(store, ServeSpec(coalesce_window_s=0.2))
        assert rp.get("k").source == "fetch"
        # inside the hold window: coalesces onto the completed flight
        assert rp.get("k").source == "coalesced"
        assert store.calls == 1
        time.sleep(0.3)  # past the window: a fresh miss fetches again
        assert rp.get("k").source == "fetch"
        assert store.calls == 2
        rp.close()

    def test_window_zero_disables_coalescing(self):
        store = CountingStore(_filled_store(["k"]), delay_s=0.02)
        rp = ReadPath(store, ServeSpec(coalesce_window_s=0.0))
        threads = [
            threading.Thread(target=rp.get, args=("k",)) for _ in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rp.close()
        assert store.calls == 8  # the uncoalesced baseline: every miss fetches

    def test_crashed_leader_retried_by_one_waiter(self):
        store = CrashingLeaderStore(_filled_store(["k"]))
        rp = ReadPath(store, ServeSpec(coalesce_window_s=0.5))
        leader_error = []
        waiter_results = []

        def leader():
            try:
                rp.get("k")
            except RuntimeError as e:
                leader_error.append(e)

        def waiter():
            waiter_results.append(rp.get("k"))

        lt = threading.Thread(target=leader)
        lt.start()
        assert store.first_started.wait(10)
        waiters = [threading.Thread(target=waiter) for _ in range(8)]
        for t in waiters:
            t.start()
        time.sleep(0.1)  # let the waiters pile onto the leader's flight
        store.release_first.set()
        lt.join()
        for t in waiters:
            t.join()
        rp.close()
        # the leader's own request surfaces its error; every waiter recovers
        # through exactly ONE retry fetch (calls = crashed leader + retry)
        assert len(leader_error) == 1
        assert len(waiter_results) == 8
        assert all(r.data == bytes(1000) for r in waiter_results)
        assert store.calls == 2


# ---------------------------------------------------------------------------
# tenant fairness
# ---------------------------------------------------------------------------


class TestTenantFairness:
    def test_token_bucket_post_paid_debt(self):
        t = [0.0]

        def clock():
            return t[0]

        def sleep(s):
            t[0] += s

        bucket = _TokenBucket(100.0, 50.0, clock, sleep)
        assert bucket.wait_for_credit() == 0.0  # full bucket: no wait
        bucket.charge(250)  # post-paid: 200 bytes into debt
        waited = bucket.wait_for_credit()
        assert waited == pytest.approx(2.0, rel=0.05)  # 200 B / 100 B/s
        assert bucket.level() > 0

    def test_unmetered_default_policy_never_waits(self):
        t = [0.0]
        bucket = _TokenBucket(0.0, 0.0, lambda: t[0], lambda s: None)
        bucket.charge(10**9)
        assert bucket.wait_for_credit() == 0.0

    def test_hot_tenant_bounded_quiet_tenant_unaffected(self):
        # adversarial skew: the hot tenant replays a Zipf popularity trace as
        # fast as it can; its backend bytes must respect the token-bucket
        # budget while the unmetered quiet tenant proceeds at full speed.
        rng_keys = [f"hot/{min(int(1.3 ** i), 200)}" for i in range(64)]
        quiet_keys = [f"quiet/{i}" for i in range(20)]
        store = CountingStore(_filled_store(set(rng_keys) | set(quiet_keys),
                                            size=10_000))
        rate, burst = 100_000.0, 20_000
        spec = ServeSpec(
            coalesce_window_s=0.0,  # every miss pays: worst case for the bound
            tenants=(
                TenantPolicy(tenant="hot", rate_bytes_per_s=rate,
                             burst_bytes=burst),
            ),
        )
        rp = ReadPath(store, spec)
        stop = time.monotonic() + 1.0
        quiet_done = []

        def hot():
            i = 0
            while time.monotonic() < stop:
                rp.get(rng_keys[i % len(rng_keys)], tenant="hot")
                i += 1

        def quiet():
            for k in quiet_keys:
                rp.get(k, tenant="quiet")
            quiet_done.append(time.monotonic())

        t0 = time.monotonic()
        threads = [threading.Thread(target=hot) for _ in range(4)]
        threads.append(threading.Thread(target=quiet))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.monotonic() - t0
        stats = rp.stats()["tenants"]
        rp.close()
        # post-paid bucket: bound = sustained rate + burst + one object of
        # overshoot per concurrent hot client
        bound = rate * elapsed + burst + 4 * 10_000
        assert stats["hot"]["backend_bytes"] <= bound
        assert stats["hot"]["throttle_wait_s"] > 0  # it really was throttled
        # the quiet tenant was never gated: finished its 20 reads quickly
        assert quiet_done and quiet_done[0] - t0 < 0.5
        assert stats["quiet"]["throttle_wait_s"] == 0.0


# ---------------------------------------------------------------------------
# hedged reads
# ---------------------------------------------------------------------------


class TestHedging:
    def test_fixed_hedge_rescues_straggler(self):
        # call 0 is a 1.5s straggler; the hedge duplicate (call 1) is fast
        store = CountingStore(_filled_store(["k"]), delays={0: 1.5})
        spec = ServeSpec(coalesce_window_s=0.0, hedge="fixed",
                         hedge_delay_s=0.05, hedge_budget_fraction=1.0)
        rp = ReadPath(store, spec)
        t0 = time.monotonic()
        res = rp.get("k")
        took = time.monotonic() - t0
        hedge = rp.stats()["hedge"]
        rp.close()
        assert res.hedged
        assert took < 1.0  # did not wait out the straggler
        assert hedge["issued"] == 1
        assert hedge["won"] == 1

    def test_slo_delay_derived_from_p50(self):
        store = CountingStore(_filled_store(["k"]))
        spec = ServeSpec(coalesce_window_s=0.0, hedge="slo", slo_p99_s=0.4,
                         hedge_min_s=0.01)
        rp = ReadPath(store, spec)
        h = rp._hedger
        assert h.delay() is None  # calibrating: too few samples
        for _ in range(32):
            h.observe(0.1)
        # fire at slo - p50: the latest moment a duplicate can still make it
        assert h.delay() == pytest.approx(0.3, rel=0.05)
        for _ in range(64):
            h.observe(0.39)
        assert h.delay() >= 0.01  # floor holds when p50 nears the SLO
        rp.close()

    def test_hedge_budget_bounds_duplicates(self):
        store = CountingStore(_filled_store(["k"]), delay_s=0.03)
        spec = ServeSpec(coalesce_window_s=0.0, hedge="fixed",
                         hedge_delay_s=0.001, hedge_budget_fraction=0.1)
        rp = ReadPath(store, spec)
        for _ in range(30):
            rp.get("k")
        hedge = rp.stats()["hedge"]
        rp.close()
        # every fetch outlives the 1ms delay, so only the budget gates
        assert hedge["issued"] <= 0.1 * hedge["requests"] + 1


# ---------------------------------------------------------------------------
# latency-objective autotune (+ the sharded-delivery skew gate)
# ---------------------------------------------------------------------------


def _mk_knob(state, name="k", lo=1, hi=256, knob_cls=Knob):
    def _set(v):
        state[name] = int(v)
        return state[name]

    return knob_cls(name, lambda: state[name], _set, lo=lo, hi=hi)


LATENCY_CFG = dict(enabled=True, objective="latency", latency_target_s=0.05,
                   interval_batches=8, min_window_s=0.0, warmup_windows=0,
                   rel_improvement=0.05)


class TestLatencyObjective:
    def test_bad_objective_rejected(self):
        with pytest.raises(ValueError, match="objective"):
            AutotuneController(AutotuneConfig(objective="bogus"), [])

    def test_on_request_minimizes_tail(self):
        # synthetic profile: request latency == knob value (ms); the inverted
        # score target/p99 must walk the knob DOWN
        cfg = AutotuneConfig(**LATENCY_CFG)
        state = {"k": 64}
        c = AutotuneController(cfg, [_mk_knob(state)])
        now = 0.0
        for _ in range(400):
            now += 1.0
            c.on_request(state["k"] / 1000.0, now=now)
        assert state["k"] < 64
        assert any(e.action == "accept" for e in c.events)

    def test_readpath_requires_latency_objective(self):
        store = _filled_store(["k"])
        spec = ServeSpec(autotune=AutotuneConfig(enabled=True))
        with pytest.raises(ValueError, match="latency"):
            ReadPath(store, spec)

    def test_readpath_autotune_probes_serve_knobs(self):
        store = CountingStore(_filled_store([f"k{i}" for i in range(600)]))
        at = AutotuneConfig(
            enabled=True, objective="latency", latency_target_s=0.05,
            interval_batches=16, min_window_s=0.0, warmup_windows=0,
        )
        spec = ServeSpec(coalesce_window_s=0.05, hedge="fixed",
                         hedge_delay_s=0.02, autotune=at)
        rp = ReadPath(store, spec)
        assert rp.autotuner is not None
        names = {k.name for k in rp.autotuner.knobs}
        assert names == {"hedge_delay_ms", "coalesce_ms"}
        for i in range(600):
            rp.get(f"k{i}")  # unique keys: every request exercises the path
        rp.close()
        assert any(e.action == "probe" for e in rp.autotuner.events)

    def test_skew_gate_blocks_up_probes_until_converged(self):
        cfg = AutotuneConfig(
            enabled=True, interval_batches=1, min_window_s=0.0,
            warmup_windows=0, skew_gate=2, reprobe_windows=0,
        )
        state = {"k": 8}
        skew = {"v": 5.0}
        c = AutotuneController(cfg, [_mk_knob(state)], skew_fn=lambda: skew["v"])
        now = 0.0
        for _ in range(6):
            now += 1.0
            c.on_batch(10, now=now)
        # lanes diverged: every up-probe was skipped and logged
        assert state["k"] == 8
        assert any(e.action == "skew" for e in c.events)
        assert not any(e.action == "probe" for e in c.events)
        skew["v"] = 0.0  # lanes re-converged: probing resumes
        for _ in range(6):
            now += 1.0
            c.on_batch(10, now=now)
        assert any(e.action == "probe" for e in c.events)

    def test_skew_gate_waits_for_sharded_delivery(self):
        """The skew gate acts only where there are lanes to diverge and a
        gate to read them: with ``skew_gate`` 0 (the default) or without a
        ``skew_fn`` (host delivery wires none) a diverged signal changes
        nothing, and the controller's events equal the reference's, the
        gated run's too."""
        trails = []
        for gate, fn in ((0, lambda: 5.0), (2, None), (2, lambda: 5.0)):
            for cfg_cls, ctrl_cls, knob_cls in ((AutotuneConfig, AutotuneController, Knob),
                                                (JaxAutotuneConfig, JaxController, JaxKnob)):
                cfg = cfg_cls(enabled=True, interval_batches=1, min_window_s=0.0,
                              warmup_windows=0, reprobe_windows=0, skew_gate=gate)
                state = {"k": 8}
                c = ctrl_cls(cfg, [_mk_knob(state, knob_cls=knob_cls)], skew_fn=fn)
                now = 0.0
                for _ in range(6):
                    now += 1.0
                    c.on_batch(10, now=now)
                trails.append([(e.action, e.knob, e.value) for e in c.events])
        assert trails[0] == trails[1] == trails[2] == trails[3]
        assert any(a == "probe" for a, _, _ in trails[0])
        assert trails[4] == trails[5] and all(a == "skew" for a, _, _ in trails[4])


def test_latency_controller_events_equal_the_references():
    """The same latency stream (a knob-dependent tail with a fixed noise
    pattern) through both controllers: the same events, action for action."""
    trails = []
    for cfg_cls, ctrl_cls, knob_cls in ((AutotuneConfig, AutotuneController, Knob),
                                        (JaxAutotuneConfig, JaxController, JaxKnob)):
        state = {"k": 64}
        c = ctrl_cls(cfg_cls(**LATENCY_CFG), [_mk_knob(state, knob_cls=knob_cls)])
        now = 0.0
        for i in range(600):
            now += 1.0
            jitter = ((i * 7919) % 13) / 1000.0
            c.on_request((abs(state["k"] - 20) + 5) / 1000.0 + jitter, now=now)
        trails.append([(e.action, e.knob, e.value) for e in c.events])
    assert trails[0] == trails[1] and trails[0]


# ---------------------------------------------------------------------------
# factory + spec plumbing
# ---------------------------------------------------------------------------


class TestFactory:
    def test_from_serve_spec(self):
        rp = make_read_path(ServeSpec(coalesce_window_s=0.1),
                            _filled_store(["k"]))
        assert isinstance(rp, ReadPath)
        assert rp.get("k").data == bytes(1000)
        rp.close()

    def test_from_run_config(self):
        from repro_torch.config import ModelConfig, RunConfig

        cfg = RunConfig(model=ModelConfig(),
                        serve=ServeSpec(coalesce_window_s=0.123))
        rp = make_read_path(cfg, _filled_store(["k"]))
        assert rp.spec.coalesce_window_s == 0.123
        rp.close()

    def test_run_config_waits_for_sharded_delivery(self):
        """A ``RunConfig`` (which came with sharded delivery) hands the read
        path its ``serve`` block, whatever its loader's delivery: a run
        configured for sharded delivery, with no mesh anywhere, still builds
        its read path (only ``make_loader`` needs the mesh), and a
        run-shaped object that is no ``RunConfig`` is refused."""
        from repro_torch.config import DeliverySpec, LoaderConfig, ModelConfig, RunConfig

        cfg = RunConfig(model=ModelConfig(),
                        loader=LoaderConfig(delivery=DeliverySpec(kind="sharded")),
                        serve=ServeSpec(coalesce_window_s=0.25))
        rp = make_read_path(cfg, _filled_store(["k"]))
        assert rp.spec is cfg.serve
        assert rp.get("k").data == bytes(1000)
        rp.close()

        class RunShaped:
            serve = ServeSpec(coalesce_window_s=0.123)

        with pytest.raises(TypeError, match="RunConfig or ServeSpec"):
            make_read_path(RunShaped(), _filled_store(["k"]))

    def test_rejects_other_configs(self):
        with pytest.raises(TypeError, match="make_read_path"):
            make_read_path(object(), _filled_store(["k"]))

    def test_bad_hedge_mode_rejected(self):
        with pytest.raises(ValueError, match="hedge"):
            ReadPath(_filled_store(["k"]), ServeSpec(hedge="sometimes"))

    def test_spec_replace_round_trips_silently(self):
        import warnings

        spec = ServeSpec(hedge="slo", slo_p99_s=0.25)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            derived = replace(spec, num_slots=8)
        assert derived.hedge == "slo"
        assert derived.num_slots == 8


# ---------------------------------------------------------------------------
# against the reference on a fake clock
# ---------------------------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_request_sequence_and_accounting_equal_the_references():
    """One thread, a fake clock, a metered and an unmetered tenant: every
    request's source, throttle wait and hedge flag, and the tenants'
    accounting, are the reference's."""
    import dataclasses

    keys = [f"k{i}" for i in range(6)]
    seq = [("a", "k0"), ("a", "k0"), ("b", "k1"), ("a", "k2"), ("b", "k0"),
           ("adv", 0.2), ("a", "k0"), ("a", "k3"), ("a", "k4"), ("b", "k4"),
           ("adv", 0.01), ("a", "k5"), ("b", "k5")]
    runs = []
    for path_cls, spec_cls, pol_cls in ((ReadPath, ServeSpec, TenantPolicy),
                                        (JaxReadPath, JaxServeSpec, JaxTenantPolicy)):
        clock = _FakeClock()
        spec = spec_cls(coalesce_window_s=0.1, tenants=(
            pol_cls(tenant="a", rate_bytes_per_s=5000.0, burst_bytes=1500),))
        rp = path_cls(_filled_store(keys), spec, clock=clock, sleep=clock.sleep)
        out = []
        for who, what in seq:
            if who == "adv":
                clock.t += what
                continue
            r = rp.get(what, tenant=who)
            out.append((r.key, r.tenant, r.source, round(r.throttled_s, 9), r.hedged,
                        len(r.data)))
        stats = rp.stats()
        rp.close()
        runs.append((out, stats, rp.audit_fetches()))
    (port, pstats, paudit), (ref, rstats, raudit) = runs
    assert port == ref
    assert dataclasses.asdict(ServeSpec()) == {
        k: v for k, v in dataclasses.asdict(JaxServeSpec()).items() if k != "autotune"
    } | {"autotune": dataclasses.asdict(AutotuneConfig())}
    for name in ("a", "b"):
        assert pstats["tenants"][name] == rstats["tenants"][name]
    assert paudit == raudit


def test_token_bucket_waits_equal_the_references():
    for bucket_cls in (_TokenBucket, JaxTokenBucket):
        clock = _FakeClock()
        b = bucket_cls(1000.0, 300.0, clock, clock.sleep)
        waits = []
        for charge, gap in ((500, 0.0), (100, 0.1), (2000, 0.05), (10, 1.0)):
            clock.t += gap
            b.charge(charge)
            waits.append(round(b.wait_for_credit(), 9))
        if bucket_cls is _TokenBucket:
            port = (waits, b.charged_bytes, round(b.waited_s, 9))
        else:
            assert (waits, b.charged_bytes, round(b.waited_s, 9)) == port
