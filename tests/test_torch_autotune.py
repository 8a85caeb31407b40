"""The port's online loader autotuner (``repro_torch.core.autotune`` and the
live knobs of both loaders) on the CPU: twins of ``tests/test_autotune.py``
(all but its four ``CongestionBoard`` cases, which need ``core/coord.py``).

Controller cases drive the reference's and the port's
``AutotuneController`` with the same synthetic throughput profile and the
same deterministic clock (``now=``), and require the same event sequence
(batch, action, knob, value; throughput to 1e-12 relative) on top of each
reference test's own asserts, except where the port departs on purpose (an
additive knob at its upper wall steps down).  The windowed signals (``window_summary``,
``recent_busy_fraction``, ``available_cpu_count``) and the
``build_*_knobs`` functions give the reference's values on the same
inputs.  Loader cases run the port only and check its own contracts:
autotune off is the stock stream,
autotune on and live resizes keep it, learned values persist across
epochs, the static config is never capped, a thread budget holds its total,
and a CPU executor swap keeps the strict stream.
"""
import gc
import threading
import time
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.autotune as jat  # noqa: E402
from repro.config import AutotuneConfig as JaxAutotuneConfig  # noqa: E402
from repro.config import LoaderConfig as JaxLoaderConfig  # noqa: E402
from repro.core import utilization as jutil  # noqa: E402
from repro.core.tracing import Tracer as JaxTracer  # noqa: E402
from repro.core.tracing import window_summary as jax_window_summary  # noqa: E402
import repro_torch.core.autotune as tat  # noqa: E402
from repro_torch.config import AutotuneConfig, LoaderConfig, PipelineConfig  # noqa: E402
from repro_torch.core import utilization as tutil  # noqa: E402
from repro_torch.core.autotune import AutotuneController  # noqa: E402
from repro_torch.core.fetcher import (  # noqa: E402
    AdjustableSemaphore,
    AsyncioFetcher,
    HedgeTracker,
    ThreadPoolFetcher,
)
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.tracing import RUN_TRAINING_BATCH, Tracer, window_summary  # noqa: E402
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore  # noqa: E402
from repro_torch.data.store import SimulatedS3Store  # noqa: E402

N_ITEMS = 96
BS = 16

SIDES = {"reference": (JaxAutotuneConfig, jat), "port": (AutotuneConfig, tat)}


@pytest.fixture(scope="module")
def dataset():
    store = SyntheticImageStore(N_ITEMS, seed=0, avg_kb=4)
    sim = SimulatedS3Store(store, latency_mean_s=0.004, bandwidth_per_conn=1e9,
                           max_connections=64)
    return ImageDataset(sim, N_ITEMS, out_size=24)


def digest(batches):
    return [(float(b["image"].sum()), b["label"].tolist()) for b in batches]


# ---------------------------------------------------------------------------
# controller on synthetic throughput profiles (no threads, no sleeping),
# each scenario run on the reference's controller and on the port's
# ---------------------------------------------------------------------------


def drive(ctrl, vals, tput_fn, steps, now=0.0):
    """Feed the controller a deterministic clock: each batch takes
    1/tput(current knobs) seconds."""
    for _ in range(steps):
        now += 1.0 / tput_fn(vals)
        ctrl.on_batch(1, now=now)
    return now


def synthetic_knobs(at, vals, bounds):
    def mk(name):
        lo, hi = bounds[name]

        def setter(v, name=name, lo=lo, hi=hi):
            vals[name] = max(lo, min(int(v), hi))
            return vals[name]

        return at.Knob(name, lambda name=name: vals[name], setter, lo, hi)

    return [mk(n) for n in vals]


def twin(scenario):
    """Run ``scenario(Cfg, at)`` with each side's ``AutotuneConfig`` and
    autotune module; it returns ``(controller, anything)``.  Both sides must
    log the same events.  Returns the port's ``(controller, anything)``."""
    out = {side: scenario(*mods) for side, mods in SIDES.items()}
    ref, port = out["reference"][0].events, out["port"][0].events
    assert [(e.batch, e.action, e.knob, e.value) for e in port] == [
        (e.batch, e.action, e.knob, e.value) for e in ref]
    np.testing.assert_allclose([e.tput for e in port], [e.tput for e in ref], rtol=1e-12)
    return out["port"]


def test_controller_converges_on_synthetic_profile():
    # tput rises with both knobs, plateaus at fetch>=16, out>=8
    def tput(v):
        return min(v["fetch"], 16) * min(v["out"], 8)

    def scenario(Cfg, at):
        vals = {"fetch": 1, "out": 1}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  warmup_windows=1, rel_improvement=0.05)
        ctrl = at.AutotuneController(
            cfg, synthetic_knobs(at, vals, {"fetch": (1, 64), "out": (1, 64)}))
        drive(ctrl, vals, tput, steps=300)
        return ctrl, vals

    ctrl, vals = twin(scenario)
    assert tput(vals) >= 0.8 * 16 * 8, (vals, ctrl.events)
    assert any(e.action == "accept" for e in ctrl.events)


def test_controller_goes_quiescent_on_flat_profile():
    def scenario(Cfg, at):
        vals = {"fetch": 4, "out": 4}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  patience=2, reprobe_windows=0)  # heartbeat off
        ctrl = at.AutotuneController(
            cfg, synthetic_knobs(at, vals, {"fetch": (1, 64), "out": (1, 64)}))
        drive(ctrl, vals, lambda v: 100.0, steps=200)
        return ctrl, vals

    ctrl, _ = twin(scenario)
    events = list(ctrl.events)
    assert any(e.action == "quiesce" for e in events)
    # heartbeat disabled: once quiescent on a stable profile, no probing
    last = max(i for i, e in enumerate(events) if e.action == "quiesce")
    assert all(e.action in ("quiesce", "restore") for e in events[last:])


def test_reprobe_heartbeat_escapes_premature_park():
    """Two early noise-reverts park the controller at a bad point whose
    throughput is stable; the heartbeat must re-probe and resume climbing."""

    def scenario(Cfg, at):
        state = {"lie": True}  # first probes measure a fake regression

        def tput(v):
            if state["lie"]:
                return 10.0 if v["fetch"] > 1 else 20.0  # punishes the climb
            return min(v["fetch"], 16) * 20.0

        vals = {"fetch": 1, "out": 4}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  patience=1, reprobe_windows=4)
        ctrl = at.AutotuneController(
            cfg, synthetic_knobs(at, vals, {"fetch": (1, 64), "out": (4, 4)}))
        now = drive(ctrl, vals, tput, steps=12)
        parked = (any(e.action == "quiesce" for e in ctrl.events), vals["fetch"])
        state["lie"] = False  # the true profile rewards concurrency
        drive(ctrl, vals, tput, steps=80, now=now)
        return ctrl, (parked, vals)

    ctrl, (parked, vals) = twin(scenario)
    assert parked == (True, 1)
    assert any(e.action == "reprobe" for e in ctrl.events)
    assert vals["fetch"] >= 16, (vals, ctrl.events)


def test_controller_rearms_on_regime_change():
    def scenario(Cfg, at):
        state = {"collapse": False}

        def tput(v):
            return min(v["fetch"], 16) * 10.0 * (0.05 if state["collapse"] else 1.0)

        vals = {"fetch": 16, "out": 4}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0, patience=1)
        ctrl = at.AutotuneController(
            cfg, synthetic_knobs(at, vals, {"fetch": (1, 64), "out": (1, 64)}))
        now = drive(ctrl, vals, tput, steps=60)
        quiesced = any(e.action == "quiesce" for e in ctrl.events)
        state["collapse"] = True  # storage got 20x slower
        drive(ctrl, vals, tput, steps=60, now=now)
        return ctrl, quiesced

    ctrl, quiesced = twin(scenario)
    assert quiesced
    assert any(e.action == "rearm" for e in ctrl.events)


def test_controller_never_exceeds_bounds():
    # adversarial deterministic "noise": tput jumps around wildly, provoking
    # accepts/reverts in all directions
    def tput(v):
        return 1.0 + ((v["fetch"] * 7919 + v["out"] * 104729) % 97)

    def scenario(Cfg, at):
        seen = []
        vals = {"fetch": 4, "out": 4}

        def setter(name):
            def s(v):
                seen.append(v)
                vals[name] = max(2, min(int(v), 32))
                return vals[name]
            return s

        knobs = [at.Knob(n, lambda n=n: vals[n], setter(n), 2, 32) for n in ("fetch", "out")]
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  patience=1000)  # never quiesce
        ctrl = at.AutotuneController(cfg, knobs)
        drive(ctrl, vals, tput, steps=500)
        return ctrl, seen

    _, seen = twin(scenario)
    assert seen, "controller never probed"
    assert all(2 <= v <= 32 for v in seen), sorted(set(seen))


def test_binary_knob_reverts_unconvincing_flip():
    def scenario(Cfg, at):
        vals = {"hedge": 0}

        def setter(v):
            vals["hedge"] = int(v)
            return vals["hedge"]

        knob = at.Knob("hedge", lambda: vals["hedge"], setter, 0, 1)
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0, patience=2)
        ctrl = at.AutotuneController(cfg, [knob])
        drive(ctrl, vals, lambda v: 50.0, steps=50)  # flat: flips never help
        return ctrl, vals

    ctrl, vals = twin(scenario)
    assert vals["hedge"] == 0  # always rolled back
    assert any(e.action == "revert" and e.knob == "hedge" for e in ctrl.events)


def test_step_schedule_coarse_then_fine():
    """The first probe jumps by the coarse factor; after a hold/revert on the
    knob the next probe uses the finer factor."""

    def scenario(Cfg, at):
        vals = {"fetch": 1}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  patience=1000)  # default schedule: (4, 2)
        ctrl = at.AutotuneController(cfg, synthetic_knobs(at, vals, {"fetch": (1, 256)}))
        drive(ctrl, vals, lambda v: 100.0, steps=40)  # flat: every probe holds
        return ctrl, vals

    ctrl, _ = twin(scenario)
    probes = [e.value for e in ctrl.events if e.action == "probe"]
    assert probes[0] == 4  # coarse x4 from 1
    assert probes[1] == 8  # refined to x2 after the hold
    assert all(b == 2 * a for a, b in zip(probes[1:], probes[2:]))  # stays fine


def test_knob_step_schedule_override():
    def scenario(Cfg, at):
        vals = {"fetch": 1}
        knob = synthetic_knobs(at, vals, {"fetch": (1, 256)})[0]
        knob.step_schedule = (8, 2)
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0, patience=1000)
        ctrl = at.AutotuneController(cfg, [knob])
        drive(ctrl, vals, lambda v: 100.0, steps=20)
        return ctrl, vals

    ctrl, _ = twin(scenario)
    probes = [e.value for e in ctrl.events if e.action == "probe"]
    assert probes[0] == 8 and probes[1] == 16


def test_additive_knob_steps_by_one():
    def scenario(Cfg, at):
        vals = {"policy": 0}

        def setter(v):
            vals["policy"] = max(0, min(int(v), 2))
            return vals["policy"]

        knob = at.Knob("policy", lambda: vals["policy"], setter, 0, 2,
                       scale="add", step_schedule=(1,))
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  patience=2, reprobe_windows=0)
        ctrl = at.AutotuneController(cfg, [knob])
        # policy 1 is strictly best: the controller must land and stay there
        drive(ctrl, vals, lambda v: (50.0, 200.0, 10.0)[v["policy"]], steps=120)
        return ctrl, vals

    ctrl, vals = twin(scenario)
    assert vals["policy"] == 1, ctrl.events
    assert {e.value for e in ctrl.events if e.action == "probe"} <= {0, 1, 2}


@pytest.mark.parametrize("wall", ["held", "accepted_then_starved", "regressed"])
def test_additive_knob_steps_down_from_its_upper_wall(wall):
    """A budget split's first up-probe lands on its upper wall (57 + 16 past
    64).  There the split is held in the dead band, or accepted on windows
    still draining the old width's work and then starved, or reverted.  The
    reference skips a knob at its upper wall and its heartbeats explore
    upward, so only a revert ever turns its split down; the port steps an
    additive knob down from the wall (ROADMAP §3) and leaves a starved wall.
    After a revert both give the same events."""

    def scenario(Cfg, at):
        vals, seen = {"split": 57, "out": 8}, {"wall": 0}

        def tput(v):
            if v["split"] != 64:
                return 100.0
            seen["wall"] += 1
            if wall == "held":
                return 100.0
            if wall == "accepted_then_starved" and seen["wall"] <= 2:
                return 150.0  # the settle and measure windows after the move
            return 10.0

        split = at.Knob("split", lambda: vals["split"],
                        lambda v: vals.__setitem__("split", max(33, min(int(v), 64)))
                        or vals["split"], 33, 64, scale="add", step_schedule=(16, 8, 1))
        out = at.Knob("out", lambda: vals["out"],
                      lambda v: vals.__setitem__("out", max(8, min(int(v), 16)))
                      or vals["out"], 8, 16)
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  patience=2, reprobe_windows=4)
        ctrl = at.AutotuneController(cfg, [split, out])
        drive(ctrl, vals, tput, steps=200)
        return ctrl, vals

    if wall == "regressed":
        ctrl, _ = twin(scenario)
        moves = [(e.action, e.value) for e in ctrl.events if e.knob == "split"]
        assert moves[:2] == [("probe", 64), ("revert", 57)]
        assert any(a == "probe" and v < 57 for a, v in moves), ctrl.events
        return
    (ref, ref_vals), (port, port_vals) = (scenario(*SIDES[side])
                                          for side in ("reference", "port"))
    for ctrl in (ref, port):
        assert [(e.action, e.value) for e in ctrl.events if e.knob == "split"][0] == ("probe", 64)
    ref_downs = [e.value for e in ref.events if e.action == "probe" and e.knob == "split"
                 and e.value < 64]
    port_downs = [e.value for e in port.events if e.action == "probe" and e.knob == "split"
                  and e.value < 64]
    assert not ref_downs and any(e.action == "reprobe" for e in ref.events), ref.events
    assert port_downs, port.events
    if wall == "accepted_then_starved":
        assert ref_vals["split"] == 64 and port_vals["split"] < 64, (ref_vals, port_vals)


def test_util_gate_blocks_up_probes_until_headroom():
    """A saturated training step (busy fraction >= util_gate) must stop the
    controller from buying more loader throughput; headroom re-enables it."""

    def scenario(Cfg, at):
        busy = {"frac": 0.98}
        vals = {"fetch": 4}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  util_gate=0.9, patience=1000)
        ctrl = at.AutotuneController(cfg, synthetic_knobs(at, vals, {"fetch": (1, 64)}),
                                     util_fn=lambda: busy["frac"])
        now = drive(ctrl, vals, lambda v: min(v["fetch"], 32) * 10.0, steps=40)
        gated = (vals["fetch"], [e.action for e in ctrl.events])
        busy["frac"] = 0.3  # headroom appeared
        drive(ctrl, vals, lambda v: min(v["fetch"], 32) * 10.0, steps=120, now=now)
        return ctrl, (gated, vals)

    ctrl, ((fetch, actions), vals) = twin(scenario)
    assert fetch == 4  # nothing bought while the accelerator is full
    assert "probe" not in actions and "gate" in actions
    assert "quiesce" not in actions  # stayed armed
    assert vals["fetch"] >= 32, (vals, ctrl.events)


def test_util_gate_off_when_no_signal():
    def scenario(Cfg, at):
        vals = {"fetch": 4}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  util_gate=0.9, patience=1000)
        ctrl = at.AutotuneController(cfg, synthetic_knobs(at, vals, {"fetch": (1, 64)}),
                                     util_fn=lambda: None)  # no step spans yet
        drive(ctrl, vals, lambda v: min(v["fetch"], 32) * 10.0, steps=60)
        return ctrl, vals

    ctrl, vals = twin(scenario)
    assert any(e.action == "probe" for e in ctrl.events)
    assert vals["fetch"] > 4


def test_entropy_floor_gates_only_reorder_window_up_probes():
    """Below ``min_shuffle_entropy`` the reorder window is not widened;
    other knobs still climb."""

    def scenario(Cfg, at):
        vals = {"reorder_window": 2, "fetch": 2}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  min_shuffle_entropy=0.5, patience=1000)
        ctrl = at.AutotuneController(
            cfg, synthetic_knobs(at, vals, {"reorder_window": (1, 64), "fetch": (1, 64)}),
            entropy_fn=lambda: 0.2)
        drive(ctrl, vals, lambda v: min(v["reorder_window"], 32) * min(v["fetch"], 8),
              steps=80)
        return ctrl, vals

    ctrl, vals = twin(scenario)
    assert not any(e.action == "probe" and e.knob == "reorder_window"
                   and e.value > 2 for e in ctrl.events)
    assert vals["reorder_window"] <= 2 and vals["fetch"] >= 8


def test_bind_resumes_at_the_best_state_and_drops_the_probe():
    """A new epoch's ``bind`` re-applies the best settled point and forgets
    the in-flight probe, as the reference's."""

    def scenario(Cfg, at):
        vals = {"fetch": 1, "out": 2}
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0, patience=1000)
        knobs = synthetic_knobs(at, vals, {"fetch": (1, 64), "out": (1, 64)})
        ctrl = at.AutotuneController(cfg, knobs)

        def tput(v):
            return min(v["fetch"], 8) * 10.0

        now = drive(ctrl, vals, tput, steps=23)
        vals["fetch"] = 1  # the next epoch's iterator starts from its config
        ctrl.bind(synthetic_knobs(at, vals, {"fetch": (1, 64), "out": (1, 64)}))
        resumed = dict(vals)
        drive(ctrl, vals, tput, steps=30, now=now)
        return ctrl, resumed

    ctrl, resumed = twin(scenario)
    assert resumed["fetch"] > 1


def test_trainer_ring_wires_util_signal(dataset):
    """``_make_ring`` hands the controller a utilization signal exactly when
    a real tracer is present (NULL_TRACER has no step spans to read), and
    the ring's depth as a knob."""
    from repro_torch.core.tracing import NULL_TRACER
    from repro_torch.train.trainer import _make_ring

    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=2,
                       num_fetch_workers=4, seed=5, autotune=AutotuneConfig(enabled=True))
    dl = ConcurrentDataLoader(dataset, cfg)
    ring = _make_ring(dl, 2, NULL_TRACER, None, "cpu")
    assert dl.autotuner.util_fn is None
    assert ring.max_depth == 8 and "device_prefetch" in [k.name for k in dl.autotuner.knobs]
    ring.close()
    tracer = Tracer()
    ring = _make_ring(dl, 2, tracer, None, "cpu")
    assert dl.autotuner.util_fn is not None
    assert dl.autotuner.util_fn() is None  # no step spans yet -> no signal
    now = time.monotonic()
    tracer.record(RUN_TRAINING_BATCH, now - 0.5, now)
    assert dl.autotuner.util_fn() > 0.0
    ring.close()


def test_tracer_recent_spans_bounded_scan():
    got = {}
    for side, tracer_cls in (("reference", JaxTracer), ("port", Tracer)):
        tr = tracer_cls()
        t = 1000.0
        for i in range(50):
            tr.record("step", t + i, t + i + 0.5)
        tr.record("other", t + 49, t + 49.5)
        recent = tr.recent_spans("step", since=t + 48.0)
        assert [s.t0 for s in recent] == [t + 48, t + 49]  # oldest first
        assert tr.recent_spans("step", since=t + 100.0) == []
        # slightly out-of-order completion near the window edge is still found
        tr.record("step", t + 48.2, t + 48.4)
        got[side] = [(s.t0, s.t1) for s in tr.recent_spans("step", since=t + 48.0)]
    assert len(got["port"]) == 3 and got["port"] == got["reference"]


def test_recent_busy_fraction_windowing():
    now = 5000.0
    for util, tracer_cls in ((jutil, JaxTracer), (tutil, Tracer)):
        tr = tracer_cls()
        assert util.recent_busy_fraction(tr, window_s=1.0, now=now) is None
        # half the window (anchored at the last completed span) covered
        tr.record(RUN_TRAINING_BATCH, now - 0.5, now)
        assert abs(util.recent_busy_fraction(tr, window_s=1.0, now=now) - 0.5) < 1e-6
        # spans overlapping the window edge are clipped, not dropped
        tr.record(RUN_TRAINING_BATCH, now - 2.0, now - 0.9)
        assert abs(util.recent_busy_fraction(tr, window_s=1.0, now=now) - 0.6) < 1e-6
        # queried MID-step, the window anchors at the last completed step
        tr2 = tracer_cls()
        tr2.record(RUN_TRAINING_BATCH, now - 4.0, now - 2.0)
        tr2.record(RUN_TRAINING_BATCH, now - 2.0, now)
        assert util.recent_busy_fraction(tr2, window_s=1.0, now=now + 1.0) == 1.0
        # ...but a stale anchor is no signal
        assert util.recent_busy_fraction(tr2, window_s=1.0, now=now + 3.0) is None
    # the same spans give the same fraction in both packages, to the bit
    rng = np.random.default_rng(0)
    spans = np.cumsum(rng.uniform(0.01, 0.2, size=(40, 2)), axis=None).reshape(40, 2)
    trs = (JaxTracer(), Tracer())
    for tr in trs:
        for t0, t1 in spans:
            tr.record(RUN_TRAINING_BATCH, float(t0), float(t1))
    end = float(spans[-1, 1]) + 0.05
    for window in (0.3, 1.0, 2.0):
        assert jutil.recent_busy_fraction(trs[0], window, end) == \
            tutil.recent_busy_fraction(trs[1], window, end)


def test_available_cpu_count_matches_the_reference(monkeypatch):
    assert tutil.available_cpu_count() == jutil.available_cpu_count() >= 1
    assert tutil._parse_cgroup_quota() == jutil._parse_cgroup_quota()
    # a quota below the affinity mask wins in both
    monkeypatch.setattr(tutil, "_parse_cgroup_quota", lambda: 1)
    monkeypatch.setattr(jutil, "_parse_cgroup_quota", lambda: 1)
    assert tutil.available_cpu_count() == jutil.available_cpu_count() == 1


def test_window_summary_aggregates():
    t = 2000.0
    got = []
    for summary, tracer_cls in ((jax_window_summary, JaxTracer), (window_summary, Tracer)):
        tr = tracer_cls()
        for i in range(10):
            tr.record("stage_a", t + i * 0.01, t + i * 0.01 + 0.005)
        tr.record("stage_b", t, t + 1.0)
        w = summary(tr, ["stage_a", "stage_b", "stage_c"], t - 1.0, t + 10.0)
        assert w["stage_a"].count == 10
        assert abs(w["stage_a"].mean_s - 0.005) < 1e-9
        assert w["stage_b"].count == 1
        assert w["stage_c"].count == 0 and w["stage_c"].rate_per_s == 0.0
        # spans ending outside the window are excluded
        w2 = summary(tr, ["stage_a"], t + 0.02, t + 0.04)
        assert w2["stage_a"].count < 10
        got.append([(n, s.count, s.mean_s, s.p50_s, s.p95_s, s.total_s, s.rate_per_s)
                    for n, s in sorted({**w, "a2": w2["stage_a"]}.items())])
    assert got[0] == got[1]


def test_diagnostics_reads_the_tracer_and_the_store(dataset):
    tr = Tracer()
    now = time.monotonic()
    tr.record("get_batch", now - 0.2, now - 0.1)
    cfg = LoaderConfig(batch_size=BS, num_workers=2, autotune=AutotuneConfig(enabled=True))
    dl = ConcurrentDataLoader(dataset, cfg, tracer=tr)
    diag = dl.autotuner.diagnostics()
    assert set(diag) == {"knobs", "best_tput", "quiescent", "stages", "store"}
    assert diag["stages"]["get_batch"]["count"] == 1
    assert diag["store"].gets >= 0


# ---------------------------------------------------------------------------
# resizable fetchers / adjustable primitives
# ---------------------------------------------------------------------------


def test_adjustable_semaphore_resize():
    sem = AdjustableSemaphore(2)
    assert sem.acquire(timeout=0.1) and sem.acquire(timeout=0.1)
    assert not sem.acquire(timeout=0.05)  # at limit
    sem.set_limit(3)
    assert sem.acquire(timeout=0.1)  # raised limit admits immediately
    sem.set_limit(1)  # shrink below held count: drains, never interrupts
    sem.release()
    sem.release()
    assert not sem.acquire(timeout=0.05)  # still 1 held >= limit 1
    sem.release()
    assert sem.acquire(timeout=0.1)
    sem.release()
    with sem:  # context manager: acquire on entry, release on exit
        assert not sem.acquire(timeout=0.05)
    assert sem.acquire(timeout=0.1)
    with pytest.raises(ValueError):
        sem.set_limit(0)


def test_threadpool_fetcher_resize_clamps(dataset):
    f = ThreadPoolFetcher(4, hard_cap=16)
    try:
        assert f.concurrency == 4
        assert f.resize(8) == 8
        assert f.resize(99) == 16  # clamped to hard cap
        assert f.resize(0) == 1
        assert len(f.fetch(dataset, list(range(8)))) == 8
    finally:
        f.close()


def test_asyncio_fetcher_resize(dataset):
    f = AsyncioFetcher(4, hard_cap=16)
    try:
        assert f.resize(12) == 12
        assert f.resize(64) == 16
        assert len(f.fetch(dataset, list(range(6)))) == 6
    finally:
        f.close()


def test_hedge_tracker_enable_toggle(dataset):
    hedge = HedgeTracker(factor=3.0, min_s=0.05)
    hedge.enabled = False
    f = ThreadPoolFetcher(4, hedge=hedge)
    try:
        f.fetch(dataset, list(range(4)))
        assert hedge.hedges_issued == 0  # disabled tracker: no hedging path
    finally:
        f.close()


# ---------------------------------------------------------------------------
# loader integration (port only): determinism under live resizing, off == stock
# ---------------------------------------------------------------------------


def _stream(dataset, **cfg_kw):
    """Epoch 0's stock stream (an earlier case may have left the shared
    dataset at another epoch)."""
    dataset.set_epoch(0)
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=2,
                       num_fetch_workers=8, seed=11, **cfg_kw)
    return digest(list(ConcurrentDataLoader(dataset, cfg)))


def test_autotune_off_is_stock_behavior(dataset):
    assert _stream(dataset) == _stream(dataset, autotune=AutotuneConfig(enabled=False))
    dl = ConcurrentDataLoader(dataset, LoaderConfig(impl="threaded", batch_size=BS))
    assert dl.autotuner is None  # no controller object, no hook in __next__


@pytest.mark.parametrize("impl", ["threaded", "asyncio"])
def test_autotune_on_preserves_stream(dataset, impl):
    cfg_kw = dict(impl=impl, batch_size=BS, num_workers=2, prefetch_factor=2,
                  num_fetch_workers=8, seed=11)
    stock = digest(list(ConcurrentDataLoader(dataset, LoaderConfig(**cfg_kw))))
    at = AutotuneConfig(enabled=True, interval_batches=1, min_window_s=0.0,
                        max_fetch_workers=16, max_outstanding=16)
    dl = ConcurrentDataLoader(dataset, LoaderConfig(autotune=at, **cfg_kw))
    assert digest(list(dl)) == stock
    # the pipeline's knobs too (strict reorder), on the same stream
    dl = ConcurrentDataLoader(dataset, LoaderConfig(
        autotune=at, pipeline=PipelineConfig(enabled=True), **cfg_kw))
    assert digest(list(dl)) == stock
    assert {k.name for k in dl.autotuner.knobs} == {
        "io_workers", "cpu_workers", "outstanding", "stage_queue"}


def test_midepoch_resize_preserves_batch_order(dataset):
    """Resizing every worker's fetch pool, or every stage of the pipeline,
    between batches must not change the delivered stream."""
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=2,
                       num_fetch_workers=8, seed=11)
    ref = digest(list(ConcurrentDataLoader(dataset, cfg)))
    sizes = [1, 16, 2, 8, 4]
    it, out = iter(ConcurrentDataLoader(dataset, cfg)), []
    for i, batch in enumerate(it):
        out.append(batch)
        for w in it.workers:
            w.fetcher.resize(sizes[i % len(sizes)])
    assert digest(out) == ref
    at = AutotuneConfig(enabled=True, interval_batches=10**6)  # knobs moved by hand
    it = iter(ConcurrentDataLoader(dataset, LoaderConfig(
        impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=2,
        num_fetch_workers=8, seed=11, autotune=at, pipeline=PipelineConfig(enabled=True))))
    out = []
    for i, batch in enumerate(it):
        out.append(batch)
        n = sizes[i % len(sizes)]
        it._set_io_workers(n)
        it._set_cpu_workers(n)
        it._set_outstanding(n)
        it._set_stage_queue(4 * n)
    assert digest(out) == ref


def test_resize_reaches_the_batch_disassembly_path(dataset):
    """With ``batch_pool`` the worker submits every item of several batches
    through the fetcher's gate (``submit_one``), so a live resize bounds
    the items fetched at once there too."""

    class Concurrency:
        def __init__(self, data):
            self.data, self.now, self.peak = data, 0, 0
            self.lock = threading.Lock()

        def __len__(self):
            return len(self.data)

        def set_epoch(self, epoch):
            self.data.set_epoch(epoch)

        def __getitem__(self, i):
            with self.lock:
                self.now += 1
                self.peak = max(self.peak, self.now)
            try:
                time.sleep(0.002)
                return self.data[i]
            finally:
                with self.lock:
                    self.now -= 1

    cfg = dict(impl="threaded", batch_size=8, num_workers=1, prefetch_factor=4,
               num_fetch_workers=8, batch_pool=2, seed=11)
    ref = digest(list(ConcurrentDataLoader(dataset, LoaderConfig(**cfg))))
    data = Concurrency(dataset)
    it = iter(ConcurrentDataLoader(data, LoaderConfig(
        autotune=AutotuneConfig(enabled=True, interval_batches=10**6), **cfg)))
    out = [next(it), next(it)]
    assert data.peak > 1
    assert it._set_fetch_workers(1) == 1
    out.append(next(it))
    with data.lock:
        # count from here only fetches that start: each waits for the gate,
        # which admits one once every earlier fetch has released its permit
        data.peak = 0
    out.extend(it)
    assert digest(out) == ref
    assert data.peak == 1


def test_autotune_state_persists_across_epochs(dataset):
    at = AutotuneConfig(enabled=True, interval_batches=1, min_window_s=0.0,
                        max_fetch_workers=16, max_outstanding=16)
    dl = ConcurrentDataLoader(dataset, LoaderConfig(
        impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=2,
        num_fetch_workers=2, seed=11, autotune=at))
    list(dl)
    dl._tuned["fetch_workers"] = 5  # as if the controller had settled there
    dl.set_epoch(1)
    it = iter(dl)
    next(it)
    # the new iterator starts from the learned values, not cfg defaults
    assert it._fetch_workers == dl._tuned["fetch_workers"]
    it.shutdown()
    pipe_dl = ConcurrentDataLoader(dataset, LoaderConfig(
        batch_size=BS, num_workers=2, seed=11, autotune=at,
        pipeline=PipelineConfig(enabled=True)))
    pipe_dl._tuned.update(io_workers=3, cpu_workers=2, stage_queue=8, outstanding=2)
    it = iter(pipe_dl)
    assert (it.io.gate.limit, it.cpu.width, it.decode_q.depth, it.max_outstanding) == (3, 2, 8, 2)
    it.shutdown()


def test_attach_ring_knob_bounds():
    class FakeRing:
        def __init__(self):
            self.depth = 2
            self.max_depth = 6

        def set_depth(self, d):
            self.depth = max(1, min(int(d), self.max_depth))
            return self.depth

    for Cfg, at in SIDES.values():
        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  min_device_prefetch=1, max_device_prefetch=8)
        ctrl = at.AutotuneController(cfg, [])
        ring = FakeRing()
        ctrl.attach_ring(ring)
        (knob,) = ctrl.knobs
        assert knob.name == "device_prefetch"
        assert (knob.lo, knob.hi) == (1, 6)  # capped by the ring's own max_depth
        assert knob.set(99) == 6 and ring.depth == 6


def test_reattach_known_knob_keeps_quiescence():
    """A converged controller stays parked when the next epoch re-attaches a
    knob it already learned (e.g. the per-epoch DevicePrefetchRing)."""

    def scenario(Cfg, at):
        vals = {"depth": 2}

        def setter(v):
            vals["depth"] = max(1, min(int(v), 8))
            return vals["depth"]

        def mk():
            return at.Knob("depth", lambda: vals["depth"], setter, 1, 8)

        cfg = Cfg(enabled=True, interval_batches=1, min_window_s=0.0,
                  patience=1, reprobe_windows=0)
        ctrl = at.AutotuneController(cfg, [])
        ctrl.attach_knob(mk())
        now = drive(ctrl, vals, lambda v: min(v["depth"], 4) * 25.0, steps=60)
        tuned, n_events = vals["depth"], len(ctrl.events)
        ctrl.attach_knob(mk())  # next epoch: same control surface, new object
        reapplied = vals["depth"] == tuned
        drive(ctrl, vals, lambda v: min(v["depth"], 4) * 25.0, steps=30, now=now)
        return ctrl, (reapplied, n_events)

    ctrl, (reapplied, n_events) = twin(scenario)
    assert any(e.action == "quiesce" for e in ctrl.events)
    assert reapplied
    assert not [e for e in list(ctrl.events)[n_events:] if e.action == "probe"]


def test_autotune_never_caps_static_config(dataset):
    """Turning the tuner ON with bounds below the explicit static config
    widens the bounds instead of clamping the loader below its off
    baseline."""
    at = AutotuneConfig(enabled=True, max_outstanding=4, max_fetch_workers=4,
                        max_cpu_workers=2, max_stage_queue=8)
    it = iter(ConcurrentDataLoader(dataset, LoaderConfig(
        impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=8,
        num_fetch_workers=8, autotune=at)))
    assert it.max_outstanding == 16  # num_workers * prefetch_factor, uncapped
    assert it._fetch_workers == 8
    it.shutdown()
    it = iter(ConcurrentDataLoader(dataset, LoaderConfig(
        batch_size=BS, num_workers=2, prefetch_factor=8, num_fetch_workers=8, autotune=at,
        pipeline=PipelineConfig(enabled=True, cpu_workers=4, stage_queue_depth=64))))
    assert (it.io.gate.limit, it.cpu.width, it.decode_q.depth, it.max_outstanding) == (
        16, 4, 64, 16)
    it.shutdown()


def test_build_budget_knobs_shape_and_schedule():
    for Cfg, at in SIDES.values():
        state = {"split": 4, "out": 8, "q": 64, "exec": 0}

        def setter(key):
            def s(n):
                state[key] = int(n)
                return int(n)
            return s

        def build(cfg):
            return at.build_budget_knobs(
                cfg, budget=16, lo_split=1, hi_split=15,
                get_split=lambda: state["split"], set_split=setter("split"),
                get_outstanding=lambda: state["out"], set_outstanding=setter("out"),
                get_queue=lambda: state["q"], set_queue=setter("q"),
                get_cpu_executor=lambda: state["exec"], set_cpu_executor=setter("exec"),
            )

        by_name = {k.name: k for k in build(Cfg(enabled=True, thread_budget=16))}
        # the independent width knobs are replaced by the coupled split knob
        assert set(by_name) == {"io_cpu_split", "outstanding", "stage_queue",
                                "cpu_executor"}
        split = by_name["io_cpu_split"]
        assert (split.lo, split.hi, split.scale) == (1, 15, "add")
        assert split.step_schedule == at.budget_split_schedule(16) == (4, 2, 1)
        assert by_name["cpu_executor"].is_binary
        assert "cpu_executor" not in {k.name for k in build(
            Cfg(enabled=True, thread_budget=16, tune_cpu_executor=False))}
        assert at.budget_split_schedule(8) == (2, 1)
        assert at.budget_split_schedule(3) == (1,)

        # weak callbacks: once the owner dies, get reports 0 / set echoes
        class Owner:
            value = 5

        owner = Owner()
        wget, wset = at.make_weak_knob_callbacks(owner)
        g, s = wget(lambda it: it.value), wset(lambda it, n: n + it.value)
        assert g() == 5 and s(2) == 7
        del owner
        gc.collect()
        assert g() == 0 and s(2) == 2


def test_build_knobs_functions_match_the_reference():
    """Every ported ``build_*_knobs`` function gives the reference's knobs (name, bounds,
    scale, schedule) on the same config and ceilings."""
    def shape(knobs):
        return [(k.name, k.lo, k.hi, k.scale, k.step_schedule) for k in knobs]

    def cb(n=0):
        return (lambda: n), (lambda v: v)

    hedge = HedgeTracker()
    for kw in (dict(tune_hedge=True), dict(max_fetch_workers=8, max_cpu_workers=2,
                                           max_reorder_window=3)):
        cfgs = [Cfg(enabled=True, **kw) for Cfg, _ in SIDES.values()]
        shapes = []
        for cfg, (_, at) in zip(cfgs, SIDES.values()):
            g, s = cb()
            shapes.append((
                shape(at.build_loader_knobs(cfg, get_fetch=g, set_fetch=s, get_outstanding=g,
                                            set_outstanding=s, hedge=hedge,
                                            max_fetch_workers=100, max_outstanding=3)),
                shape(at.build_pipeline_knobs(cfg, get_io=g, set_io=s, get_cpu=g, set_cpu=s,
                                              get_outstanding=g, set_outstanding=s,
                                              get_queue=g, set_queue=s, hedge=hedge,
                                              max_io=70, max_cpu=40, max_queue=600,
                                              get_reorder=g, set_reorder=s)),
                shape(at.build_budget_knobs(cfg, budget=68, lo_split=36, hi_split=67,
                                            get_split=g, set_split=s, get_outstanding=g,
                                            set_outstanding=s, get_queue=g, set_queue=s,
                                            hedge=hedge, get_reorder=g, set_reorder=s)),
            ))
        assert shapes[0] == shapes[1]


# ---------------------------------------------------------------------------
# config: the ported fields, the flat-kwarg shim, the budget floor
# ---------------------------------------------------------------------------

# the reference's AutotuneConfig fields of features the port lacks
UNPORTED = {
    "min_slab_slots", "max_slab_slots",  # item 5.4
    "skew_gate",  # item 7
    "min_hedge_delay_ms", "max_hedge_delay_ms", "min_coalesce_ms", "max_coalesce_ms",
    "objective", "latency_target_s", "latency_quantile",  # item 5.7
}


def test_autotune_config_keeps_the_reference_fields_and_defaults():
    import dataclasses

    ref = {f.name: f.default for f in dataclasses.fields(JaxAutotuneConfig)}
    port = {f.name: f.default for f in dataclasses.fields(AutotuneConfig)}
    assert set(ref) - set(port) == UNPORTED
    assert port == {k: v for k, v in ref.items() if k not in UNPORTED}
    assert LoaderConfig().autotune == AutotuneConfig()


def test_flat_pipeline_kwargs_fold_into_the_nested_config_as_the_reference():
    kw = dict(pipeline=True, reorder="window", reorder_window=3, cpu_workers=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port = LoaderConfig(**kw)
        ref = JaxLoaderConfig(**kw)
    assert sum(issubclass(w.category, DeprecationWarning) for w in caught) == 8
    fields = ("enabled", "reorder", "reorder_window", "io_workers", "cpu_workers",
              "cpu_executor", "stage_queue_depth", "staging_buffers")
    assert [getattr(port.pipeline, f) for f in fields] == [
        getattr(ref.pipeline, f) for f in fields]
    assert (port.reorder, port.cpu_workers) == ("window", 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # replace() never re-fires the shim
        from dataclasses import replace

        assert replace(port, seed=3).pipeline == port.pipeline
    # a flat kwarg beside a nested config folds into it
    with pytest.warns(DeprecationWarning):
        cfg = LoaderConfig(pipeline=PipelineConfig(enabled=True, staging_buffers=2),
                           io_workers=5)
    assert (cfg.pipeline.io_workers, cfg.pipeline.staging_buffers) == (5, 2)


def test_thread_budget_floor_is_checked(dataset):
    with pytest.raises(ValueError, match="thread_budget=1"):
        ConcurrentDataLoader(dataset, LoaderConfig(
            pipeline=PipelineConfig(enabled=True),
            autotune=AutotuneConfig(enabled=True, thread_budget=1)))


# ---------------------------------------------------------------------------
# budget co-tuning and the executor swap (port only)
# ---------------------------------------------------------------------------


def test_thread_budget_holds_the_total_width(dataset):
    """Under ``thread_budget`` the controller moves one coupled io/cpu split:
    at every batch of every epoch the two widths add up to the budget, and
    the stream is the stock one."""
    budget = 10
    # 12 batches an epoch, 2 outstanding: windows close before the drain
    kw = dict(impl="threaded", batch_size=8, num_workers=2, prefetch_factor=1,
              num_fetch_workers=8, seed=11)
    dataset.set_epoch(0)
    stock = digest(list(ConcurrentDataLoader(dataset, LoaderConfig(**kw))))
    at = AutotuneConfig(enabled=True, interval_batches=1, min_window_s=0.0,
                        thread_budget=budget, tune_cpu_executor=False, patience=1000)
    dl = ConcurrentDataLoader(dataset, LoaderConfig(
        autotune=at, pipeline=PipelineConfig(enabled=True), **kw))
    for ep in range(2):
        dl.set_epoch(ep)
        it, out, sums = iter(dl), [], []
        for batch in it:
            out.append(batch)
            sums.append(it.io.gate.limit + it.cpu.width)
        assert sums == [budget] * len(out) and len(out) == 12
        stats = dl.stage_stats()
        assert stats["thread_budget"] == budget
        assert stats["io_workers"] + stats["cpu_workers"] == budget
        if ep == 0:
            assert digest(out) == stock
    assert [k.name for k in dl.autotuner.knobs] == ["io_cpu_split", "outstanding",
                                                    "stage_queue"]
    assert any(e.action == "probe" and e.knob == "io_cpu_split" for e in dl.autotuner.events)


def test_thread_budget_split_stays_under_the_io_cap(dataset):
    """A budget wider than the IO stage's hard cap plus one CPU worker: the
    split's ceiling is the cap, so a split learned above it (the reference's
    ceiling is budget - 1, which left IO at the cap and threads of the
    budget unused) still gives IO + CPU = the budget."""
    budget, cap = 10, 4
    kw = dict(impl="threaded", batch_size=8, num_workers=1, prefetch_factor=1,
              num_fetch_workers=cap, seed=11)
    at = AutotuneConfig(enabled=True, interval_batches=10**6, thread_budget=budget,
                        max_fetch_workers=cap, tune_cpu_executor=False)
    dl = ConcurrentDataLoader(dataset, LoaderConfig(
        autotune=at, pipeline=PipelineConfig(enabled=True), **kw))
    dl._tuned["io_cpu_split"] = budget - 1  # as if learned in an earlier epoch
    dl.set_epoch(0)
    it = iter(dl)
    sums = [it.io.gate.limit + it.cpu.width for _ in it]
    assert sums == [budget] * len(sums) and len(sums) == 12
    assert (it._split_hi, it.io.gate.limit) == (cap, cap)
    assert it._set_split(budget - 1) == cap


def test_cpu_executor_swap_keeps_the_strict_stream(dataset):
    """The budget-mode executor knob swaps the CPU stage between threads and
    spawned processes mid-epoch, and back; the paused stage finishes its
    in-flight samples and the strict stream is unchanged."""
    stock = _stream(dataset)
    at = AutotuneConfig(enabled=True, interval_batches=10**6, thread_budget=4)
    dl = ConcurrentDataLoader(dataset, LoaderConfig(
        impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=2,
        num_fetch_workers=8, seed=11, autotune=at, pipeline=PipelineConfig(enabled=True)))
    try:
        it = iter(dl)
        assert "cpu_executor" in [k.name for k in dl.autotuner.knobs]
        out = [next(it)]
        assert it._set_cpu_executor(1) == 1 and it.cpu_kind == "process"
        assert not it._thread_cpu.active and it._proc_cpu.active
        out += [next(it), next(it), next(it)]
        assert it._proc_cpu.pipe_samples > 0
        assert it._set_cpu_executor(0) == 0 and it.cpu_kind == "thread"
        out.extend(it)
        assert digest(out) == stock
        assert dl._tuned["cpu_executor"] == 0
        stats = dl.stage_stats()
        assert stats["cpu_executor"] == "thread" and stats["cpu_pool"]["crashes"] == 0
        assert stats["io_workers"] + stats["cpu_workers"] == 4
        # the learned kind carries into the next epoch
        dl._tuned["cpu_executor"] = 1
        dl.set_epoch(0)
        it = iter(dl)
        assert it.cpu_kind == "process"
        assert digest(list(it)) == stock
    finally:
        dl.close()


def test_executor_flip_spawns_only_on_the_pump_thread(dataset, monkeypatch):
    """A flip to the process kind in the middle of an epoch runs on the
    consumer's thread (the device ring's, on a trainer): it must start no
    interpreter there.  Every spawn runs on the stage's pump thread, and
    the strict stream is unchanged."""
    from repro_torch.core import pipeline as P

    spawned_on = []
    real_spawn = P._CPUProcessPool.spawn_one

    def spawn_one(pool):
        spawned_on.append(threading.current_thread().name)
        real_spawn(pool)

    monkeypatch.setattr(P._CPUProcessPool, "spawn_one", spawn_one)
    stock = _stream(dataset)
    at = AutotuneConfig(enabled=True, interval_batches=10**6, thread_budget=4)
    dl = ConcurrentDataLoader(dataset, LoaderConfig(
        impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=2,
        num_fetch_workers=8, seed=11, autotune=at, pipeline=PipelineConfig(enabled=True)))
    try:
        it = iter(dl)
        out = [next(it)]
        caller = threading.current_thread().name
        assert it._set_cpu_executor(1) == 1
        out.extend(it)
        assert digest(out) == stock
        assert it._proc_cpu.pipe_samples > 0
        assert spawned_on and set(spawned_on) == {"pipe-cpu-pool-pump"}
        assert caller not in spawned_on
    finally:
        dl.close()


def test_stages_grow_lazily_toward_their_width(dataset):
    """A ceiling costs nothing until a resize asks for it: the thread CPU
    stage starts threads only up to its current width, and the process pool
    grows by at most ``PROC_SPAWN_STEP`` workers a pump pass."""
    from repro_torch.core import pipeline as P

    stop = threading.Event()
    q = P._BoundedQ(8, stop)
    stage = P._CPUStage(dataset, width=2, hard_cap=32, decode_q=q, done_q=None, stop=stop,
                        tracer=Tracer())
    try:
        assert (len(stage.threads), stage.width) == (2, 2)
        assert stage.resize(5) == 5 and len(stage.threads) == 5
        assert stage.resize(99) == 32 and len(stage.threads) == 32
        assert stage.resize(3) == 3 and len(stage.threads) == 32  # surplus idles
        assert q.resize(100, 16) == 16 and q.depth == 16
    finally:
        stop.set()
        stage.join()
    pool = P._CPUProcessPool(b"", hard_cap=10)
    pool.spawn_one = lambda: pool.workers.append(object())  # no process here
    grown = []
    for _ in range(4):
        pool.ensure(10)
        grown.append(len(pool.workers))
    assert grown == [P.PROC_SPAWN_STEP, 2 * P.PROC_SPAWN_STEP, 10, 10]


def test_budget_split_probe_runs_chip_smokes_budget_run(monkeypatch):
    """``repro_torch.tools.budget_split_probe`` repeats chip_smoke's budget
    run at other budgets: the same launcher arguments, and a card it asks
    for rather than falling back to the CPU."""
    import chip_smoke
    import torch

    from repro_torch.tools import budget_split_probe

    assert budget_split_probe.ARGS == chip_smoke.AUTO_ARGS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        budget_split_probe.main(["65"])
