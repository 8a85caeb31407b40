"""Twins of ``tests/test_coord.py`` on the port alone (file locks, key
sharding, TTL leases, the shared disk journal under spawned writers, the
append log, the membership, congestion and shard boards, cooperative
up-probes, the loader's wiring), the same cases and assertions with the
imports pointed at ``repro_torch``.  Spawned children run targets from
``tests/torch_fleet_children.py``, which imports no torch, each under a
time limit of its own."""
import json
import multiprocessing
import os
import threading
import time

import pytest

pytest.importorskip("torch")

from repro_torch.config import AutotuneConfig, LoaderConfig, StoreConfig  # noqa: E402
from repro_torch.core.autotune import AutotuneController, Knob  # noqa: E402
from repro_torch.core.coord import (  # noqa: E402
    CongestionBoard,
    EpochShardBoard,
    FileLock,
    JsonDiskJournal,
    MembershipBoard,
    SharedCounter,
    SharedDiskJournal,
    UpProbeLease,
    host_shard,
    validate_lease_events,
)
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.data.cache import DiskTierCache, MemoryTierCache, TieredCacheStore  # noqa: E402
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore  # noqa: E402
from repro_torch.data.store import InMemoryStore, build_store  # noqa: E402
from torch_fleet_children import (  # noqa: E402
    append_log_writer,
    count_worker,
    counter_log,
    crash_compactor,
    journal_writer,
    reap,
)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_file_lock_excludes_threads(tmp_path):
    lock = FileLock(str(tmp_path / "l.lock"))
    counter = {"v": 0, "max_inside": 0, "inside": 0}

    def work():
        for _ in range(50):
            with lock:
                counter["inside"] += 1
                counter["max_inside"] = max(counter["max_inside"], counter["inside"])
                v = counter["v"]
                counter["v"] = v + 1
                counter["inside"] -= 1

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert counter["v"] == 200
    assert counter["max_inside"] == 1


def test_host_shard_stable_and_in_range():
    for n in (1, 2, 3, 7):
        for k in ("a", "img/000123.jpg", "x" * 100):
            s = host_shard(k, n)
            assert 0 <= s < n
            assert s == host_shard(k, n)  # stable
    # spread: 100 keys over 4 hosts should hit every shard
    assert {host_shard(f"k{i}", 4) for i in range(100)} == {0, 1, 2, 3}


def test_shared_counter_across_processes(tmp_path):
    path = str(tmp_path / "nic.count")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=count_worker, args=(path, 25)) for _ in range(2)]
    for p in procs:
        p.start()
    assert reap(procs, 60) == [0, 0]
    c = SharedCounter(path)
    assert c.value() == 50
    assert c.add(-50) == 0


# ---------------------------------------------------------------------------
# up-probe lease
# ---------------------------------------------------------------------------


def test_lease_mutual_exclusion_and_release(tmp_path):
    a = UpProbeLease(str(tmp_path), owner="a", ttl_s=30)
    b = UpProbeLease(str(tmp_path), owner="b", ttl_s=30)
    assert a.try_acquire()
    assert a.try_acquire()  # re-entrant for the holder
    assert not b.try_acquire()
    assert a.renew()
    assert not b.renew()  # renew never steals
    a.release()
    assert b.try_acquire()
    audit = validate_lease_events(a.read_events())
    assert audit.ok and audit.holders == 2 and audit.acquisitions == 2


def test_lease_ttl_expiry_heals_crashed_holder(tmp_path):
    a = UpProbeLease(str(tmp_path), owner="crashed", ttl_s=0.2)
    b = UpProbeLease(str(tmp_path), owner="survivor", ttl_s=30)
    assert a.try_acquire()
    assert not b.try_acquire()
    time.sleep(0.25)  # "crashed" never releases; TTL lapses
    assert b.try_acquire()
    assert not a.renew()  # the old holder cannot resurrect its lease
    audit = validate_lease_events(b.read_events())
    assert audit.ok, audit.violations


def test_lease_audit_flags_real_overlap(tmp_path):
    a = UpProbeLease(str(tmp_path), owner="a", ttl_s=30)
    assert a.try_acquire()
    # forge a concurrent acquisition by a second owner (bypassing the lock
    # discipline) — the auditor must catch it
    with open(a.events_path, "a") as f:
        f.write(json.dumps({"owner": "rogue", "event": "acquire",
                            "t": time.time(), "expires_at": time.time() + 30}) + "\n")
    audit = validate_lease_events(a.read_events())
    assert not audit.ok and audit.violations


# ---------------------------------------------------------------------------
# shared disk journal: cross-process byte accounting (the tentpole bound)
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


def test_two_process_writers_never_overshoot_capacity(tmp_path):
    """Satellite: two multiprocessing writers against ONE shared disk tier
    stay within capacity_bytes and converge to consistent stats."""
    cache_dir = str(tmp_path / "shared")
    os.makedirs(cache_dir)
    capacity = 20_000
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    procs = [
        ctx.Process(
            target=journal_writer,
            args=(cache_dir, capacity, i, 30, 1_500, outs[i]),
        )
        for i in range(2)
    ]
    for p in procs:
        p.start()
    peak = 0
    deadline = time.monotonic() + 60
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        peak = max(peak, _dir_bytes(cache_dir))
        time.sleep(0.005)
    assert reap(procs, 10) == [0, 0]
    peak = max(peak, _dir_bytes(cache_dir))
    assert peak <= capacity, f"disk overshot: {peak} > {capacity}"

    journal = SharedDiskJournal(cache_dir, capacity)
    assert journal.used_bytes() <= capacity
    # journal accounting agrees with the directory
    assert journal.used_bytes() == _dir_bytes(cache_dir)
    # stats converge: fleet-wide admitted - evicted bytes == bytes on disk
    stats = [json.load(open(o)) for o in outs]
    admitted = sum(s["bytes_admitted"] for s in stats)
    evicted = sum(s["bytes_evicted"] for s in stats)
    assert admitted - evicted == journal.used_bytes()


def test_journal_reserve_expiry_reclaims_crashed_writer(tmp_path):
    cache_dir = str(tmp_path)
    j = SharedDiskJournal(cache_dir, 1_000, reserve_ttl_s=0.1)
    assert j.reserve("dead", 900).ok  # reserved, then the "writer crashes"
    # a live writer can't fit until the stale reservation expires
    assert not j.reserve("live", 900).ok
    time.sleep(0.15)
    res = j.reserve("live", 900)
    assert res.ok and res.evicted == 1
    assert j.used_bytes() == 900


def test_journal_rereserve_same_key_after_writer_crash(tmp_path):
    """Regression: an EXPIRED provisional reservation for key K must not be
    treated as a dedup hit — that would return True with no file ever
    written, permanently blocking K from the cache (and pinning phantom
    bytes under no capacity pressure)."""
    cache_dir = str(tmp_path)
    j = SharedDiskJournal(cache_dir, 0, reserve_ttl_s=0.05)  # unbounded
    assert j.reserve("f", 100).ok  # writer crashes before writing
    time.sleep(0.1)
    res = j.reserve("f", 100)  # a live writer retries the same key
    assert res.ok and not res.dedup  # fresh reservation, not a phantom hit
    assert j.finalize("f")
    assert j.used_bytes() == 100  # no double accounting


def test_journal_eviction_reclaims_stalled_writers_tmp_bytes(tmp_path):
    """A writer that stalls after writing its tmp file but past its
    reservation TTL must not leave unaccounted bytes on disk when a peer
    evicts the expired reservation (the fleet byte bound would be wrong)."""
    cache_dir = str(tmp_path)
    j = SharedDiskJournal(cache_dir, 1_000, reserve_ttl_s=0.05)
    assert j.reserve("deadf00d", 900).ok
    stalled_tmp = tmp_path / "deadf00d.tmp1234-5678"
    stalled_tmp.write_bytes(b"s" * 900)  # stalled writer got this far
    time.sleep(0.1)
    res = j.reserve("11ve", 900)  # peer evicts the expired reservation
    assert res.ok and res.evicted == 1
    assert not stalled_tmp.exists()  # tmp bytes reclaimed with the budget


def test_shard_mode_rejects_out_of_range_host_id(tmp_path):
    with pytest.raises(ValueError, match="0-based"):
        DiskTierCache(str(tmp_path), 1_000, shard=(3, 3))


def test_journal_mode_tier_survives_reinit_and_external_delete(tmp_path):
    cache_dir = str(tmp_path)
    t1 = DiskTierCache(cache_dir, 10_000, journal=SharedDiskJournal(cache_dir, 10_000))
    t1.put("k", b"v" * 100)
    # a second process arrives: reconcile adopts nothing, keeps accounting
    t2 = DiskTierCache(cache_dir, 10_000, journal=SharedDiskJournal(cache_dir, 10_000))
    assert t2.used_bytes == 100
    assert t2.get("k") == b"v" * 100
    # external delete: first get repairs the shared accounting
    os.remove(os.path.join(cache_dir, t2._fname("k")))
    assert t2.get("k") is None
    assert t2.used_bytes == 0


# ---------------------------------------------------------------------------
# shard mode
# ---------------------------------------------------------------------------


def test_shard_mode_partitions_accounting_but_shares_reads(tmp_path):
    cache_dir = str(tmp_path)
    hosts = [DiskTierCache(cache_dir, 100_000, shard=(i, 2)) for i in range(2)]
    keys = [f"k{i}" for i in range(40)]
    for k in keys:
        owner = host_shard(k, 2)
        assert hosts[owner].put(k, k.encode())
        # the non-owner skips the write (peer's budget) but reads the entry
        other = hosts[1 - owner]
        assert not other.put(k, k.encode())
        assert other.get(k) == k.encode()
    for i, h in enumerate(hosts):
        own = [k for k in keys if host_shard(k, 2) == i]
        assert h.used_bytes == sum(len(k) for k in own)
        assert h.stats().shard_foreign == len(keys) - len(own)
    # re-init only adopts the host's own shard
    h0b = DiskTierCache(cache_dir, 100_000, shard=(0, 2))
    assert h0b.used_bytes == hosts[0].used_bytes


# ---------------------------------------------------------------------------
# cooperative autotune: the up-probe token serializes upward probes
# ---------------------------------------------------------------------------


def _mk_ctrl(tmp_path, name, vals):
    def setter(v):
        vals["fetch"] = max(1, min(int(v), 64))
        return vals["fetch"]

    cfg = AutotuneConfig(enabled=True, interval_batches=1, min_window_s=0.0,
                         warmup_windows=1, coord_dir=str(tmp_path))
    lease = UpProbeLease(str(tmp_path), owner=name, ttl_s=30)
    knobs = [Knob("fetch", lambda: vals["fetch"], setter, 1, 64)]
    return AutotuneController(cfg, knobs, probe_lease=lease)


def test_cooperative_controllers_serialize_up_probes(tmp_path):
    va, vb = {"fetch": 4}, {"fetch": 4}
    a = _mk_ctrl(tmp_path, "host-a", va)
    b = _mk_ctrl(tmp_path, "host-b", vb)
    now = 0.0
    for _ in range(3):  # a: anchor, warmup, baseline -> probe (acquires)
        now += 1.0
        a.on_batch(1, now=now)
    assert any(e.action == "probe" for e in a.events)
    assert a._lease_held
    for _ in range(3):  # b wants up but the token is taken -> "lease" skip
        now += 1.0
        b.on_batch(1, now=now)
    assert any(e.action == "lease" for e in b.events)
    assert not any(e.action == "probe" for e in b.events)
    assert vb["fetch"] == 4  # b never moved
    # a reverts (simulated regression -> tput 0-ish) and releases the token
    a.on_batch(1, now=now + 1)   # settle window passes
    a.on_batch(1, now=now + 100)  # measured window: terrible tput -> revert
    assert any(e.action == "revert" for e in a.events)
    assert not a._lease_held
    # now b's next window can climb
    b.on_batch(1, now=now + 101)
    assert any(e.action == "probe" for e in b.events)
    audit = validate_lease_events(a.probe_lease.read_events())
    assert audit.ok, audit.violations


def test_release_coordination_is_idempotent_and_frees_peers(tmp_path):
    v = {"fetch": 4}
    a = _mk_ctrl(tmp_path, "host-a", v)
    now = 0.0
    for _ in range(3):
        now += 1.0
        a.on_batch(1, now=now)
    assert a._lease_held
    a.release_coordination()
    a.release_coordination()
    assert not a._lease_held
    b = UpProbeLease(str(tmp_path), owner="host-b", ttl_s=30)
    assert b.try_acquire()


def test_controller_without_lease_is_unchanged(tmp_path):
    """coord off => no lease object is ever consulted (bit-identical path)."""
    cfg = AutotuneConfig(enabled=True, interval_batches=1, min_window_s=0.0,
                         warmup_windows=1)
    vals = {"fetch": 4}
    ctrl = AutotuneController(
        cfg,
        [Knob("fetch", lambda: vals["fetch"],
              lambda v: vals.update(fetch=int(v)) or vals["fetch"], 1, 64)],
    )
    assert ctrl.probe_lease is None
    for i in range(10):
        ctrl.on_batch(1, now=float(i))
    assert any(e.action == "probe" for e in ctrl.events)
    assert not os.listdir(str(tmp_path))  # nothing was written anywhere


# ---------------------------------------------------------------------------
# wiring: build_store coord modes + loader lease + epoch cache cadence
# ---------------------------------------------------------------------------


def test_build_store_journal_and_shard_modes(tmp_path):
    base = InMemoryStore()
    base.put("k", b"v" * 10)
    cfg_j = StoreConfig(kind="memory", cache_dir=str(tmp_path / "j"),
                        disk_cache_bytes=1_000, cache_coord="journal")
    st = build_store(cfg_j, base=base)
    assert st.get("k") == b"v" * 10
    assert st.disk.journal is not None
    cfg_s = StoreConfig(kind="memory", cache_dir=str(tmp_path / "s"),
                        disk_cache_bytes=1_000, cache_coord="shard",
                        cache_coord_host_id=1, cache_coord_num_hosts=4)
    st2 = build_store(cfg_s, base=base)
    assert st2.disk.shard == (1, 4)
    with pytest.raises(ValueError):
        build_store(
            StoreConfig(kind="memory", cache_dir=str(tmp_path / "x"),
                        cache_coord="bogus"),
            base=base,
        )


def _tiny_loader(tmp_path, **auto_kw):
    n = 48
    store = SyntheticImageStore(n, seed=0, avg_kb=2)
    cache = TieredCacheStore(
        store,
        memory=MemoryTierCache(4 << 10),
        disk=DiskTierCache(str(tmp_path / "cache"), 1 << 20),
    )
    ds = ImageDataset(cache, n, out_size=8)
    cfg = LoaderConfig(
        impl="threaded", batch_size=8, num_workers=2, prefetch_factor=2,
        num_fetch_workers=2,
        autotune=AutotuneConfig(enabled=True, interval_batches=2,
                                min_window_s=0.0, **auto_kw),
    )
    return ConcurrentDataLoader(ds, cfg)


def test_loader_wires_probe_lease_from_coord_dir(tmp_path):
    coord = tmp_path / "coord"
    loader = _tiny_loader(tmp_path, coord_dir=str(coord))
    assert loader.autotuner.probe_lease is not None
    for _ in iter(loader):
        pass
    loader.release_coordination()
    # the coord dir exists and the lease is free for a peer
    peer = UpProbeLease(str(coord), owner="peer", ttl_s=30)
    assert peer.try_acquire()


def test_loader_epoch_cadence_runs_cache_knobs_on_second_controller(tmp_path):
    loader = _tiny_loader(
        tmp_path,
        cache_cadence="epoch",
        cache_epoch_windows=1,
        max_memory_cache_bytes=1 << 20,
    )
    assert loader.cache_autotuner is not None
    # the per-batch controller got NO cache knobs (they live on the epoch one)
    for epoch in range(4):
        if epoch:
            loader.set_epoch(epoch)
        for _ in iter(loader):
            pass
        assert all("cache" not in k.name for k in loader.autotuner.knobs)
    cache_knobs = {k.name for k in loader.cache_autotuner.knobs}
    assert "cache_mem_bytes" in cache_knobs
    # fed once per epoch: anchor + 3 windows -> the controller probed
    assert any(e.action == "probe" for e in loader.cache_autotuner.events)


def test_loader_batch_cadence_keeps_cache_knobs_on_main_controller(tmp_path):
    loader = _tiny_loader(tmp_path, max_memory_cache_bytes=1 << 20)
    assert loader.cache_autotuner is None
    it = iter(loader)
    assert any(k.name == "cache_mem_bytes" for k in loader.autotuner.knobs)
    for _ in it:
        pass


def test_loader_rejects_unknown_cache_cadence(tmp_path):
    with pytest.raises(ValueError, match="cache_cadence"):
        _tiny_loader(tmp_path, cache_cadence="epochs")


def test_controller_aborts_up_probe_when_lease_renewal_lost(tmp_path):
    """A TTL lapse mid-probe hands the token to a peer; the orphaned upward
    move must be rolled back, not silently continued (two live up-probes)."""
    vals = {"fetch": 4}
    a = _mk_ctrl(tmp_path, "host-a", vals)
    a.probe_lease.ttl_s = 0.05  # lapse between windows
    now = 0.0
    for _ in range(3):
        now += 1.0
        a.on_batch(1, now=now)
    assert a._lease_held and vals["fetch"] > 4
    time.sleep(0.1)  # TTL lapses...
    b = UpProbeLease(str(tmp_path), owner="host-b", ttl_s=30)
    assert b.try_acquire()  # ...and a peer takes the token
    a.on_batch(1, now=now + 1.0)  # next window: renewal fails -> abort
    assert not a._lease_held
    assert vals["fetch"] == 4  # the orphaned up-move was rolled back
    assert any(e.action == "revert" for e in a.events)


# ---------------------------------------------------------------------------
# append-log substrate
# ---------------------------------------------------------------------------


_counter_log = counter_log  # the reference's helper, shared with the spawned children


def test_append_log_replay_and_bounded_resync(tmp_path):
    a = _counter_log(str(tmp_path))
    for _ in range(10):
        with a.update() as (st, emit):
            emit({"op": "add", "d": 1})
    # a fresh instance replays the whole segment once...
    b = _counter_log(str(tmp_path))
    with b.view() as st:
        assert st["v"] == 10
    first_replay = b.replayed_records
    # ...and subsequent syncs fold in only NEW records (bounded replay)
    with a.update() as (st, emit):
        emit({"op": "add", "d": 5})
    with b.view() as st:
        assert st["v"] == 15
    assert b.replayed_records == first_replay + 1


def test_append_log_compaction_retires_old_segment(tmp_path):
    a = _counter_log(str(tmp_path), compact_every=8)
    for _ in range(20):
        with a.update() as (st, emit):
            emit({"op": "add", "d": 1})
    assert a.compactions >= 2
    segs = [n for n in os.listdir(tmp_path) if ".seg" in n]
    assert len(segs) == 1  # old generations swept
    b = _counter_log(str(tmp_path))
    with b.view() as st:
        assert st["v"] == 20
    # after a compaction the snapshot stands in for the full history
    assert b.replayed_records <= 8 + 1


def test_append_log_torn_tail_truncated(tmp_path):
    a = _counter_log(str(tmp_path))
    for _ in range(5):
        with a.update() as (st, emit):
            emit({"op": "add", "d": 1})
    seg = os.path.join(tmp_path, "cnt.seg00000000.log")
    size_before = os.path.getsize(seg)
    with open(seg, "ab") as f:
        f.write(b'{"op":"add","d":99')  # writer died mid-append: no newline
    b = _counter_log(str(tmp_path))
    with b.view() as st:
        assert st["v"] == 5  # the unacknowledged record never happened
    assert b.torn_tails_recovered == 1
    assert os.path.getsize(seg) == size_before  # tail physically truncated
    # the healed log accepts new records
    with b.update() as (st, emit):
        emit({"op": "add", "d": 1})
    with b.view() as st:
        assert st["v"] == 6


def test_append_log_unparseable_tail_truncated(tmp_path):
    a = _counter_log(str(tmp_path))
    with a.update() as (st, emit):
        emit({"op": "add", "d": 3})
    seg = os.path.join(tmp_path, "cnt.seg00000000.log")
    with open(seg, "ab") as f:
        f.write(b'{"op":"add","d":#corrupt#}\n')  # terminated but garbage
    b = _counter_log(str(tmp_path))
    with b.view() as st:
        assert st["v"] == 3
    assert b.torn_tails_recovered == 1


def test_append_log_concurrent_writers_with_compaction(tmp_path):
    """Satellite: compaction raced by concurrent writers must lose no
    records — every process compacts eagerly (compact_every=5) while the
    others append."""
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=append_log_writer, args=(str(tmp_path), 40, 5))
        for _ in range(3)
    ]
    for p in procs:
        p.start()
    assert reap(procs, 120) == [0, 0, 0]
    log = _counter_log(str(tmp_path))
    with log.view() as st:
        assert st["v"] == 120
    assert len([n for n in os.listdir(tmp_path) if ".seg" in n]) == 1


@pytest.mark.parametrize("hook", ["after_seg", "after_gen"])
def test_append_log_crash_mid_compaction_recovers(tmp_path, hook):
    """Satellite: kill the compactor in both crash windows — after the new
    segment is written but before the generation bump (orphan new segment),
    and after the bump but before the old segment's unlink (orphan old
    segment).  Either way the survivors read the exact pre-crash state."""
    a = _counter_log(str(tmp_path))
    for _ in range(7):
        with a.update() as (st, emit):
            emit({"op": "add", "d": 1})
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=crash_compactor, args=(str(tmp_path), hook))
    p.start()
    assert reap([p], 60) == [17]  # died exactly at the injected crash point
    b = _counter_log(str(tmp_path))
    with b.view() as st:
        assert st["v"] == 7
    # the next compaction sweeps whatever orphan the crash left behind
    b.compact()
    assert len([n for n in os.listdir(tmp_path) if ".seg" in n]) == 1
    with _counter_log(str(tmp_path)).view() as st:
        assert st["v"] == 7


def test_journal_migrates_legacy_json_index(tmp_path):
    """A pre-append-log index.json is folded into the gen-0 snapshot at
    first open and retired as index.json.migrated."""
    coord = tmp_path / ".coord"
    coord.mkdir()
    (tmp_path / "a.bin").write_bytes(b"x" * 700)
    (tmp_path / "b.bin").write_bytes(b"x" * 200)
    legacy = {
        "capacity": 1_000,
        "entries": [["a.bin", 700, True, 0.0], ["b.bin", 200, True, 0.0]],
    }
    (coord / "index.json").write_text(json.dumps(legacy))
    j = SharedDiskJournal(str(tmp_path), 1_000)
    assert j.entry_count() == 2
    assert j.used_bytes() == 900
    assert not os.path.exists(coord / "index.json")
    assert os.path.exists(str(coord / "index.json") + ".migrated")
    # migrated entries participate in LRU eviction as usual
    r = j.reserve("c.bin", 400)
    assert r.ok and r.evicted == 1 and r.evicted_bytes == 700
    assert not os.path.exists(tmp_path / "a.bin")


def test_json_journal_same_api_smoke(tmp_path):
    """The legacy implementation stays importable behind the identical API
    (bench baseline + migration source)."""
    j = JsonDiskJournal(str(tmp_path), 1_000)
    assert j.reserve("a.bin", 600).ok
    assert j.finalize("a.bin")
    (tmp_path / "a.bin").write_bytes(b"x" * 600)
    assert j.reserve("a.bin", 600).dedup
    r = j.reserve("b.bin", 600)
    assert r.ok and r.evicted == 1
    assert j.used_bytes() == 600 and j.entry_count() == 1


# ---------------------------------------------------------------------------
# membership / congestion / epoch-shard boards
# ---------------------------------------------------------------------------


class _FakeClock:
    def __init__(self, t=1_000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_membership_join_heartbeat_expiry_reap(tmp_path):
    clk = _FakeClock()
    a = MembershipBoard(str(tmp_path), member="a", ttl_s=10, clock=clk)
    b = MembershipBoard(str(tmp_path), member="b", ttl_s=10, clock=clk)
    a.join()
    gen = b.join()
    assert set(a.live()) == {"a", "b"}
    clk.t += 6
    a.heartbeat()  # extends a's lease; b's now expires at t=1010
    clk.t += 6  # t=1012: b expired, a live until 1016
    assert set(a.live()) == {"a"}
    gen2 = a.heartbeat()  # reaps b
    assert gen2 == gen + 1  # departure bumped the fleet generation
    assert not a.is_live("b")
    # a reaped member's next heartbeat re-joins it (with another bump)
    gen3 = b.heartbeat()
    assert gen3 == gen2 + 1 and a.is_live("b")
    # join/leave/reap transitions land in the audit log
    events = [
        json.loads(ln)
        for ln in open(tmp_path / "membership_audit.jsonl")
        if ln.strip()
    ]
    assert [e["event"] for e in events].count("reap") == 1
    reap = next(e for e in events if e["event"] == "reap")
    assert reap["member"] == "b" and reap["by"] == "a"


def test_membership_leave_is_immediate(tmp_path):
    clk = _FakeClock()
    a = MembershipBoard(str(tmp_path), member="a", ttl_s=100, clock=clk)
    a.join()
    assert a.is_live("a")
    a.leave()
    assert not a.is_live("a")


def test_congestion_board_post_poll_rate_limit(tmp_path):
    clk = _FakeClock()
    a = CongestionBoard(str(tmp_path), host="a", clock=clk)
    b = CongestionBoard(str(tmp_path), host="b", clock=clk)
    assert b.last_seq() == 0
    seq = a.post_shed(123.0)
    assert seq == 1  # the event's own seq: polling from it skips ourselves
    latest, events = b.poll(0)
    assert latest == 1 and len(events) == 1
    assert events[0]["h"] == "a" and events[0]["tput"] == 123.0
    # rate limit: b observing the same collapse does NOT stack a second shed
    assert b.post_shed(100.0, min_interval_s=5.0) is None
    assert b.last_seq() == 1
    clk.t += 6
    assert b.post_shed(90.0, min_interval_s=5.0) is not None
    latest, events = a.poll(1)
    assert latest == 2 and [e["h"] for e in events] == ["b"]


def test_shard_board_claim_progress_complete(tmp_path):
    clk = _FakeClock()
    board = EpochShardBoard(str(tmp_path), owner="a", ttl_s=10, clock=clk)
    assert board.setup(0, num_batches=10, shard_batches=4) == 3
    c = board.claim_next(0)
    assert (c.shard, c.start, c.end, c.next_b) == (0, 0, 4, 0)
    board.progress(0, 0, 4)  # confirming the last batch flips done
    assert board.snapshot(0)["0"]["done"]
    for want in (1, 2):
        c = board.claim_next(0)
        assert c.shard == want
        board.progress(0, c.shard, c.end)
    assert board.all_done(0)
    assert board.claim_next(0) is None


def test_shard_board_lease_expiry_takeover_resumes_cursor(tmp_path):
    clk = _FakeClock()
    a = EpochShardBoard(str(tmp_path), owner="a", ttl_s=10, clock=clk)
    b = EpochShardBoard(str(tmp_path), owner="b", ttl_s=10, clock=clk)
    a.setup(0, 8, 8)
    ca = a.claim_next(0)
    a.progress(0, ca.shard, 3)  # a confirmed batches 0..2, then stalls
    assert b.claim_next(0) is None  # live lease: no takeover
    clk.t += 11  # a's lease expires
    cb = b.claim_next(0)
    assert cb is not None and cb.next_b == 3  # resumes at a's cursor
    # a's stale renew must fail: the claim moved
    assert not a.renew(0, ca.shard)


def test_shard_board_membership_reap_takeover(tmp_path):
    """A dead-but-unexpired claim is reapable the moment its owner vanishes
    from the membership board (no TTL wait)."""
    clk = _FakeClock()
    mem = MembershipBoard(str(tmp_path), member="a", ttl_s=5, clock=clk)
    mem.join()
    a = EpochShardBoard(
        str(tmp_path), owner="a", ttl_s=1_000, clock=clk, membership=mem
    )
    memb = MembershipBoard(str(tmp_path), member="b", ttl_s=5, clock=clk)
    b = EpochShardBoard(
        str(tmp_path), owner="b", ttl_s=1_000, clock=clk, membership=memb
    )
    a.setup(0, 4, 4)
    a.claim_next(0)
    memb.join()
    assert b.claim_next(0) is None  # a is live; its long lease holds
    clk.t += 6  # a's MEMBERSHIP lease expires (no heartbeat = departure)
    cb = b.claim_next(0)
    assert cb is not None and cb.shard == 0


def test_shard_board_exclude_skips_own_inflight_shard(tmp_path):
    """Regression: the board's progress cursor lags delivery confirmation,
    so a host that finished DISPATCHING its shard must not re-claim it via
    the own-shard-reclaim path (that re-runs in-flight batches)."""
    clk = _FakeClock()
    board = EpochShardBoard(str(tmp_path), owner="a", ttl_s=10, clock=clk)
    board.setup(0, 4, 4)
    c = board.claim_next(0)
    assert c.shard == 0
    # no progress posted yet — without exclude we'd re-claim shard 0
    assert board.claim_next(0, exclude=frozenset({0})) is None
    again = board.claim_next(0)
    assert again is not None and again.shard == 0  # restart path still works


def test_upprobe_lease_reaps_vanished_holder(tmp_path):
    """Satellite bugfix: a holder that dies between acquire and its first
    renew leaves a live-looking lease; with a membership board wired, a
    peer reaps it immediately instead of idling out the TTL."""
    clk = _FakeClock()
    mem_a = MembershipBoard(str(tmp_path), member="host-a", ttl_s=5, clock=clk)
    mem_a.join()
    lease_a = UpProbeLease(
        str(tmp_path), owner="host-a", ttl_s=1_000, membership=mem_a
    )
    assert lease_a.try_acquire()
    # host-a dies: no heartbeat, membership lease expires
    clk.t += 6
    mem_b = MembershipBoard(str(tmp_path), member="host-b", ttl_s=5, clock=clk)
    mem_b.join()
    lease_b = UpProbeLease(
        str(tmp_path), owner="host-b", ttl_s=30, membership=mem_b
    )
    assert lease_b.try_acquire()  # reaped, not blocked for 1000 s
    events = lease_b.read_events()
    kinds = [e.event for e in events]
    assert "reap" in kinds and kinds.index("reap") < kinds.index("takeover")
    audit = validate_lease_events(events)
    assert audit.ok, audit.violations


def test_upprobe_lease_without_membership_waits_ttl(tmp_path):
    """Without a membership board the reap path must stay off: a live
    foreign lease blocks until its own TTL, exactly as before."""
    lease_a = UpProbeLease(str(tmp_path), owner="host-a", ttl_s=1_000)
    assert lease_a.try_acquire()
    lease_b = UpProbeLease(str(tmp_path), owner="host-b", ttl_s=30)
    assert not lease_b.try_acquire()


# ---------------------------------------------------------------------------
# cooperative down-shedding: twins of the four CongestionBoard and shed
# cases of tests/test_autotune.py
# ---------------------------------------------------------------------------


def drive(ctrl, vals, tput_fn, steps):
    """Feed the controller a deterministic clock: each batch takes
    1/tput(current knobs) seconds."""
    now = 0.0
    for _ in range(steps):
        now += 1.0 / tput_fn(vals)
        ctrl.on_batch(1, now=now)
    return now


def synthetic_knobs(vals, bounds):
    def mk(name):
        lo, hi = bounds[name]

        def setter(v, name=name, lo=lo, hi=hi):
            vals[name] = max(lo, min(int(v), hi))
            return vals[name]

        return Knob(name, lambda name=name: vals[name], setter, lo, hi)

    return [mk(n) for n in vals]


def _drive_on(ctrl, vals, tput_fn, steps, now):
    """Like ``drive`` but continues an existing clock — multi-phase shed
    tests must not rewind time between phases."""
    for _ in range(steps):
        now += 1.0 / tput_fn(vals)
        ctrl.on_batch(1, now=now)
    return now


def _shed_cfg(**kw):
    base = dict(enabled=True, interval_batches=1, min_window_s=0.0,
                warmup_windows=1, rel_improvement=0.05,
                shed_collapse_fraction=0.5, shed_md_factor=0.5,
                shed_hold_windows=1, shed_recover_windows=4,
                shed_min_interval_s=0.0)
    base.update(kw)
    return AutotuneConfig(**base)


def _plateau(v):
    return min(v["fetch"], 16) * 4


def test_shed_cuts_multiplicatively_and_recovers_additively(tmp_path):
    from repro_torch.core.coord import CongestionBoard

    vals = {"fetch": 1}
    ctrl = AutotuneController(
        _shed_cfg(), synthetic_knobs(vals, {"fetch": (1, 64)}),
        congestion=CongestionBoard(str(tmp_path), host="a"),
    )
    collapsed = {"on": False}

    def tput(v):
        return 0.1 if collapsed["on"] else _plateau(v)

    now = drive(ctrl, vals, tput, steps=200)
    pre = vals["fetch"]
    assert pre >= 16  # converged before the collapse
    collapsed["on"] = True
    now = _drive_on(ctrl, vals, tput, 2, now)
    assert any(e.action == "shed" for e in ctrl.events)
    assert vals["fetch"] == max(1, pre // 2)  # multiplicative decrease
    # collapse clears: additive climb back to the pre-shed operating point
    collapsed["on"] = False
    _drive_on(ctrl, vals, tput, 12, now)
    recovers = [e for e in ctrl.events if e.action == "recover"]
    assert len(recovers) >= 2  # several additive steps, not one jump
    assert vals["fetch"] >= pre
    # the shed landed on the fleet board
    board = CongestionBoard(str(tmp_path), host="x")
    assert board.last_seq() >= 1


def test_peer_shed_event_cuts_this_host(tmp_path):
    from repro_torch.core.coord import CongestionBoard

    vals = {"fetch": 1}
    ctrl = AutotuneController(
        _shed_cfg(), synthetic_knobs(vals, {"fetch": (1, 64)}),
        congestion=CongestionBoard(str(tmp_path), host="b"),
    )
    now = drive(ctrl, vals, _plateau, steps=200)
    pre = vals["fetch"]
    # another host observes the collapse first and posts fleet-wide
    CongestionBoard(str(tmp_path), host="a").post_shed(1.0)
    _drive_on(ctrl, vals, _plateau, 2, now)
    assert any(e.action == "shed_peer" for e in ctrl.events)
    assert vals["fetch"] == max(1, pre // 2)
    # we honored the peer's event without stacking our own on the board
    assert not any(e.action == "shed" for e in ctrl.events)


def test_shed_off_without_congestion_board():
    vals = {"fetch": 1}
    collapsed = {"on": False}

    def tput(v):
        return 0.1 if collapsed["on"] else _plateau(v)

    ctrl = AutotuneController(_shed_cfg(),
                              synthetic_knobs(vals, {"fetch": (1, 64)}))
    now = drive(ctrl, vals, tput, steps=200)
    collapsed["on"] = True
    _drive_on(ctrl, vals, tput, 5, now)
    assert not any(e.action in ("shed", "shed_peer") for e in ctrl.events)


def test_shed_leaves_binary_knobs_alone(tmp_path):
    from repro_torch.core.coord import CongestionBoard

    vals = {"fetch": 8, "hedge": 1}
    # (0, 1) bounds make "hedge" a binary toggle (Knob.is_binary)
    knobs = synthetic_knobs(vals, {"fetch": (1, 64), "hedge": (0, 1)})
    ctrl = AutotuneController(
        _shed_cfg(), knobs,
        congestion=CongestionBoard(str(tmp_path), host="a"),
    )
    now = drive(ctrl, vals, _plateau, steps=60)
    CongestionBoard(str(tmp_path), host="peer").post_shed(1.0)
    fetch_pre, hedge_pre = vals["fetch"], vals["hedge"]
    _drive_on(ctrl, vals, _plateau, 2, now)
    assert vals["fetch"] < fetch_pre  # scalable knob cut...
    assert vals["hedge"] == hedge_pre  # ...binary toggle untouched
