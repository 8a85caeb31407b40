"""The port's coordination held against the reference's, and mixed fleets of
the two: a reference writer and a port writer (two spawned processes, each
under its own time limit, neither importing torch) share one disk-tier
journal and never overshoot its capacity together; a reference controller
and a port controller on one ``coord_dir`` never hold the up-probe lease at
once; on the same synthetic profile with shedding on, the port's event
trail equals the reference's, and a shed posted by either package cuts the
other; the same seed and membership schedule give each elastic member the
same claims in both packages, and a reference member and a port member in
one fleet cover an epoch exactly.  Inputs are drawn from a seed or a
deterministic clock; every comparison is exact."""
import json
import multiprocessing
import os
import threading
import time

import pytest

pytest.importorskip("torch")

import repro.core.autotune as jat  # noqa: E402
import repro.core.coord as jcoord  # noqa: E402
import repro.core.elastic as jelastic  # noqa: E402
from repro.config import AutotuneConfig as JaxAutotuneConfig  # noqa: E402
from repro.config import LoaderConfig as JaxLoaderConfig  # noqa: E402
from repro.core.loader import ConcurrentDataLoader as JaxLoader  # noqa: E402
import repro_torch.core.autotune as tat  # noqa: E402
import repro_torch.core.coord as tcoord  # noqa: E402
import repro_torch.core.elastic as telastic  # noqa: E402
from repro_torch.config import AutotuneConfig, LoaderConfig  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.sampler import ShardedBatchSampler  # noqa: E402
from torch_fleet_children import (  # noqa: E402
    BS,
    batch_key,
    elastic_config,
    elastic_dataset,
    journal_writer,
    reap,
)

SIDES = {"reference": (jat, jcoord, jelastic, JaxAutotuneConfig),
         "port": (tat, tcoord, telastic, AutotuneConfig)}


# ---------------------------------------------------------------------------
# one disk-tier journal, a reference writer and a port writer
# ---------------------------------------------------------------------------


def _dir_bytes(d):
    total = 0
    for f in os.listdir(d):
        if f.startswith("."):
            continue
        try:  # tmp files vanish between listdir and stat (live writers)
            total += os.path.getsize(os.path.join(d, f))
        except OSError:
            pass
    return total


def test_reference_and_port_writers_never_overshoot_one_journal(tmp_path):
    cache_dir = str(tmp_path / "shared")
    os.makedirs(cache_dir)
    capacity = 20_000
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    procs = [ctx.Process(target=journal_writer,
                         args=(cache_dir, capacity, i, 30, 1_500, outs[i], pkg))
             for i, pkg in enumerate(("repro", "repro_torch"))]
    for p in procs:
        p.start()
    peak = 0
    deadline = time.monotonic() + 60
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        peak = max(peak, _dir_bytes(cache_dir))
        time.sleep(0.005)
    assert reap(procs, 10) == [0, 0]  # 86 = torch was imported in a writer
    peak = max(peak, _dir_bytes(cache_dir))
    assert peak <= capacity, f"disk overshot: {peak} > {capacity}"
    stats = [json.load(open(o)) for o in outs]
    admitted = sum(s["bytes_admitted"] for s in stats)
    evicted = sum(s["bytes_evicted"] for s in stats)
    # both packages' journals read the same total, equal to the directory
    for coord in (jcoord, tcoord):
        journal = coord.SharedDiskJournal(cache_dir, capacity)
        assert journal.used_bytes() == _dir_bytes(cache_dir) <= capacity
        assert admitted - evicted == journal.used_bytes()
    assert all(s["admitted"] for s in stats)  # both writers got bytes in


# ---------------------------------------------------------------------------
# the up-probe lease across packages
# ---------------------------------------------------------------------------


def _leased_ctrl(side, coord_dir, name, vals):
    at, coord, _, cfg_cls = SIDES[side]

    def setter(v):
        vals["fetch"] = max(1, min(int(v), 64))
        return vals["fetch"]

    cfg = cfg_cls(enabled=True, interval_batches=1, min_window_s=0.0,
                  warmup_windows=1, coord_dir=coord_dir)
    lease = coord.UpProbeLease(coord_dir, owner=name, ttl_s=30)
    return at.AutotuneController(cfg, [at.Knob("fetch", lambda: vals["fetch"], setter, 1, 64)],
                                 probe_lease=lease)


def test_reference_and_port_controllers_never_hold_the_lease_at_once(tmp_path):
    coord_dir = str(tmp_path / "coord")
    vals = {"reference": {"fetch": 2}, "port": {"fetch": 2}}
    ctrls = {side: _leased_ctrl(side, coord_dir, f"{side}-host", vals[side])
             for side in SIDES}
    # each host's throughput climbs with its own fetch width up to 16, then
    # falls: probes are accepted, then reverted, so the token changes hands
    now = {side: 0.0 for side in SIDES}
    both_held = 0
    for step in range(400):
        side = ("reference", "port")[step % 2]
        v = vals[side]["fetch"]
        tput = v if v <= 16 else 32 - v
        now[side] += 1.0 / max(tput, 0.5)
        ctrls[side].on_batch(1, now=now[side])
        both_held += all(c._lease_held for c in ctrls.values())
    assert both_held == 0
    actions = {side: {e.action for e in c.events} for side, c in ctrls.items()}
    assert all("probe" in a for a in actions.values()), actions
    assert any("lease" in a for a in actions.values()), actions  # they contended
    for c in ctrls.values():
        c.release_coordination()
    events = {side: SIDES[side][1].UpProbeLease(coord_dir, owner="audit").read_events()
              for side in SIDES}
    assert [e.__dict__ for e in events["port"]] == [e.__dict__ for e in events["reference"]]
    for side, coord in ((s, SIDES[s][1]) for s in SIDES):
        audit = coord.validate_lease_events(events[side])
        assert audit.ok and audit.holders == 2, (side, audit.violations)
    assert events["port"][-1].event == "release"


# ---------------------------------------------------------------------------
# fleet shedding
# ---------------------------------------------------------------------------


def _shed_cfg(cfg_cls, **kw):
    base = dict(enabled=True, interval_batches=1, min_window_s=0.0,
                warmup_windows=1, rel_improvement=0.05,
                shed_collapse_fraction=0.5, shed_md_factor=0.5,
                shed_hold_windows=1, shed_recover_windows=4,
                shed_min_interval_s=0.0)
    base.update(kw)
    return cfg_cls(**base)


def _knobs(at, vals, bounds):
    def mk(name):
        lo, hi = bounds[name]

        def setter(v, name=name, lo=lo, hi=hi):
            vals[name] = max(lo, min(int(v), hi))
            return vals[name]

        return at.Knob(name, lambda name=name: vals[name], setter, lo, hi)

    return [mk(n) for n in vals]


def _profile(collapsed):
    # two multiplicative knobs, neither parked at its upper wall (ROADMAP §3:
    # only an additive knob there makes the packages' trails differ)
    def tput(v):
        if collapsed["on"]:
            return 0.2
        return min(v["fetch"], 16) * 2 + min(v["outstanding"], 8)
    return tput


def test_shed_trail_equals_the_references(tmp_path):
    trails = {}
    for side, (at, coord, _, cfg_cls) in SIDES.items():
        vals = {"fetch": 1, "outstanding": 2}
        ctrl = at.AutotuneController(
            _shed_cfg(cfg_cls),
            _knobs(at, vals, {"fetch": (1, 64), "outstanding": (1, 64)}),
            congestion=coord.CongestionBoard(str(tmp_path / side), host="a"))
        collapsed = {"on": False}
        tput, now = _profile(collapsed), 0.0
        for phase, steps in ((False, 200), (True, 3), (False, 40), (True, 3), (False, 60)):
            collapsed["on"] = phase
            for _ in range(steps):
                now += 1.0 / tput(vals)
                ctrl.on_batch(1, now=now)
        trails[side] = [(e.batch, e.action, e.knob, e.value) for e in ctrl.events]
    assert trails["port"] == trails["reference"]
    actions = [a for _, a, _, _ in trails["port"]]
    assert actions.count("shed") == 2 and "recover" in actions and "probe" in actions


@pytest.mark.parametrize("poster", ["reference", "port"])
def test_a_shed_posted_by_either_package_cuts_the_other(tmp_path, poster):
    other = "port" if poster == "reference" else "reference"
    board_dir = str(tmp_path / "board")
    at, coord, _, cfg_cls = SIDES[other]
    vals = {"fetch": 1, "outstanding": 2}
    ctrl = at.AutotuneController(
        _shed_cfg(cfg_cls), _knobs(at, vals, {"fetch": (1, 64), "outstanding": (1, 64)}),
        congestion=coord.CongestionBoard(board_dir, host=f"{other}-host"))
    tput, now = _profile({"on": False}), 0.0
    for _ in range(200):
        now += 1.0 / tput(vals)
        ctrl.on_batch(1, now=now)
    pre = dict(vals)
    assert SIDES[poster][1].CongestionBoard(board_dir, host=f"{poster}-host").post_shed(1.0) == 1
    for _ in range(2):
        now += 1.0 / tput(vals)
        ctrl.on_batch(1, now=now)
    assert [e.action for e in ctrl.events if e.action.startswith("shed")] == ["shed_peer"]
    assert vals == {k: max(1, v // 2) for k, v in pre.items()}


# ---------------------------------------------------------------------------
# elastic membership: the same claims, and one mixed fleet
# ---------------------------------------------------------------------------

N_CLAIM_ITEMS = 96


def _claims(side, coord_dir):
    """Two members drawing one epoch on a fake clock: ``a`` alone for 3
    batches, then ``b`` joins and they alternate; ``a`` leaves after its
    7th batch (its in-flight shard is taken over), ``b`` drains the rest.
    Returns every claimed (member, epoch, shard, global batch, indices)."""
    _, _, elastic, _ = SIDES[side]
    clock = {"t": 1_000.0}
    cfg = elastic_config(coord_dir, pkg="repro" if side == "reference" else "repro_torch",
                         lease_ttl_s=5.0, heartbeat_interval_s=1.0, shard_batches=2)
    ses = {m: elastic.ElasticSession(cfg, member=m, clock=lambda: clock["t"]) for m in "ab"}
    samp = {m: elastic.ElasticBatchSampler(N_CLAIM_ITEMS, BS, shuffle=True, seed=3,
                                           session=ses[m], sleep=lambda s: None)
            for m in "ab"}
    its, out, done, left = {"a": iter(samp["a"])}, [], set(), False
    schedule = ["a"] * 3 + ["b", "a"] * 40
    for turn, m in enumerate(schedule):
        clock["t"] += 0.5
        if m == "b" and "b" not in its:
            its["b"] = iter(samp["b"])
        if m in done or (m == "a" and left):
            continue
        try:
            bi = next(its[m])
        except telastic.ClaimStarved if side == "port" else jelastic.ClaimStarved:
            continue
        except StopIteration:
            done.add(m)
            continue
        epoch, shard, gb = samp[m]._pending[-1]
        out.append((m, epoch, shard, gb, bi.indices))
        samp[m].note_delivered()
        if m == "a" and sum(1 for o in out if o[0] == "a") == 7:
            ses["a"].leave()  # clean leave: its claim is reapable at once
            left = True
    return out


def test_same_schedule_gives_the_same_claims_in_both_packages(tmp_path):
    got = {side: _claims(side, str(tmp_path / side)) for side in SIDES}
    assert got["port"] == got["reference"]
    want = sorted(b.indices for b in ShardedBatchSampler(N_CLAIM_ITEMS, BS, shuffle=True,
                                                         seed=3))
    # the union covers the epoch: a's unconfirmed tail may run twice
    # (at-least-once), nothing outside the epoch appears, nothing is lost
    seen = [o[4] for o in got["port"]]
    assert sorted(set(seen)) == want
    assert {o[0] for o in got["port"]} == {"a", "b"}


def test_reference_and_port_members_cover_an_epoch_exactly(tmp_path):
    coord = tmp_path / "coord"
    sides = {"reference": (JaxLoader, JaxLoaderConfig, "repro"),
             "port": (ConcurrentDataLoader, LoaderConfig, "repro_torch")}
    outs = {side: [] for side in sides}
    errors = []

    def run(side, host):
        loader_cls, cfg_cls, pkg = sides[side]
        try:
            ds = elastic_dataset(160, 0.004, pkg=pkg)
            cfg = cfg_cls(impl="threaded", batch_size=BS, num_workers=2,
                          num_fetch_workers=4, seed=7, elastic=elastic_config(coord, pkg=pkg))
            dl = loader_cls(ds, cfg, host_id=host, num_hosts=1)
            for b in dl:
                outs[side].append(batch_key(b))
                time.sleep(0.01)  # a consumer that leaves work for the peer
            dl.release_coordination()
        except Exception as exc:  # surfaced below, in the test's thread
            errors.append((side, exc))

    ts = [threading.Thread(target=run, args=(side, h)) for h, side in enumerate(sides)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=90)
        assert not t.is_alive(), "mixed elastic fleet hung"
    assert not errors, errors
    ds = elastic_dataset(160, 0.004)
    want = sorted(batch_key(b) for b in ConcurrentDataLoader(ds, LoaderConfig(
        impl="threaded", batch_size=BS, num_workers=2, num_fetch_workers=4, seed=7)))
    assert sorted(outs["reference"] + outs["port"]) == want  # no loss, no duplicate
    assert outs["reference"] and outs["port"], {k: len(v) for k, v in outs.items()}
    for coord_mod in (jcoord, tcoord):  # both left: the fleet is empty
        assert coord_mod.MembershipBoard(str(coord), member="audit").live() == {}
