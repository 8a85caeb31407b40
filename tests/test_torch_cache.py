"""Twins of ``tests/test_cache.py`` on the port alone (tier bounds under
parallel writers, LRU eviction, admission policies, crash recovery, async
paths, the autotuner's cache knobs), the same cases and assertions with the
imports pointed at ``repro_torch``; then the twin of
``tests/test_config_api.py::TestCacheConfigNesting`` (the nested
``CacheConfig`` and the flat-kwarg shim)."""
import asyncio
import os
import threading
import time
import warnings
from dataclasses import replace

import pytest

pytest.importorskip("torch")

from repro_torch.config import (  # noqa: E402
    AutotuneConfig,
    CacheConfig,
    LoaderConfig,
    StoreConfig,
)
from repro_torch.core.autotune import AutotuneController, build_cache_knobs  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.tracing import CACHE_GET, Tracer  # noqa: E402
from repro_torch.data.cache import (  # noqa: E402
    ADMISSION_KINDS,
    AdmitAll,
    DiskTierCache,
    MemoryTierCache,
    SecondHitAdmission,
    SizeThresholdAdmission,
    TieredCacheStore,
    TinyLFUAdmission,
    make_admission,
)
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore  # noqa: E402
from repro_torch.data.store import (  # noqa: E402
    CachedStore,
    DiskCacheStore,
    InMemoryStore,
    ObjectStore,
    SimulatedS3Store,
    build_store,
)


def _disk_bytes(d: str) -> int:
    return sum(
        os.path.getsize(os.path.join(d, f))
        for f in os.listdir(d)
        if ".tmp" not in f
    )


# ---------------------------------------------------------------------------
# memory tier
# ---------------------------------------------------------------------------


def test_memory_tier_sharded_never_exceeds_capacity():
    c = MemoryTierCache(4096, shards=4)
    for i in range(64):
        c.put(f"k{i}", bytes(200))
    assert c.used_bytes <= 4096
    s = c.stats()
    assert s.evictions > 0 and s.bytes_used == c.used_bytes


def test_memory_tier_set_capacity_shrink_evicts():
    c = MemoryTierCache(1000, shards=1)
    for i in range(5):
        c.put(f"k{i}", bytes(200))
    assert c.used_bytes == 1000
    assert c.set_capacity(400) == 400
    assert c.used_bytes <= 400
    # the survivors are the most recently used (LRU eviction)
    assert c.get("k4") is not None and c.get("k0") is None


def test_memory_tier_concurrent_bound():
    c = MemoryTierCache(16_384, shards=8)
    peak = [0]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], c.used_bytes)

    def writer(t):
        for i in range(200):
            c.put(f"w{t}-{i}", bytes(512))

    s = threading.Thread(target=sample)
    s.start()
    ts = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    stop.set()
    s.join()
    assert peak[0] <= 16_384


# ---------------------------------------------------------------------------
# disk tier: bounds, LRU, admission, recovery
# ---------------------------------------------------------------------------


def test_disk_tier_roundtrip_and_stats(tmp_path):
    d = DiskTierCache(str(tmp_path), capacity_bytes=1 << 20)
    assert d.get("k") is None
    assert d.put("k", b"hello")
    assert d.get("k") == b"hello"
    s = d.stats()
    assert s.hits == 1 and s.misses == 1 and s.admitted == 1
    assert s.bytes_used == 5


def test_disk_tier_parallel_writers_never_exceed_capacity(tmp_path):
    cap = 64 * 1024
    d = DiskTierCache(str(tmp_path), capacity_bytes=cap)
    peak = [0]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            try:
                peak[0] = max(peak[0], _disk_bytes(str(tmp_path)))
            except OSError:
                pass  # a file vanished mid-scan (eviction) — retry

    s = threading.Thread(target=sample)
    s.start()

    def writer(t):
        for i in range(40):
            d.put(f"w{t}-{i}", bytes(4096))

    ts = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    stop.set()
    s.join()
    assert peak[0] <= cap, f"disk tier overshot: peak {peak[0]} > cap {cap}"
    assert _disk_bytes(str(tmp_path)) <= cap
    assert d.used_bytes == _disk_bytes(str(tmp_path))
    assert d.stats().evictions > 0


def test_disk_tier_eviction_picks_lru(tmp_path):
    d = DiskTierCache(str(tmp_path), capacity_bytes=1000)
    d.put("a", bytes(400))
    d.put("b", bytes(400))
    assert d.get("a") is not None  # touch a: b is now LRU
    d.put("c", bytes(400))  # over capacity: evicts b
    assert d.get("b") is None
    assert d.get("a") is not None and d.get("c") is not None


def test_disk_tier_size_threshold_admission(tmp_path):
    d = DiskTierCache(
        str(tmp_path), capacity_bytes=1 << 20,
        admission=SizeThresholdAdmission(100),
    )
    assert not d.put("big", bytes(200))
    assert d.get("big") is None
    assert d.put("small", bytes(50))
    assert d.get("small") is not None
    assert d.stats().rejected == 1


def test_disk_tier_second_hit_admission(tmp_path):
    d = DiskTierCache(
        str(tmp_path), capacity_bytes=1 << 20, admission=SecondHitAdmission()
    )
    assert not d.put("k", b"x")  # first sighting: recorded, not admitted
    assert d.get("k") is None
    assert d.put("k", b"x")  # second sighting: admitted
    assert d.get("k") == b"x"


def test_disk_tier_item_larger_than_capacity_rejected(tmp_path):
    d = DiskTierCache(str(tmp_path), capacity_bytes=100)
    assert not d.put("big", bytes(200))
    assert d.used_bytes == 0 and not os.listdir(str(tmp_path))


def test_disk_tier_purges_orphan_tmp_files_on_init(tmp_path):
    d1 = DiskTierCache(str(tmp_path))
    d1.put("keep", b"payload")
    # simulate a crashed writer: a STALE tmp file next to a valid entry
    # (mtime backdated past the live-writer grace window)
    orphan = tmp_path / "deadbeef.tmp12345"
    orphan.write_bytes(b"partial write")
    stale = time.time() - 3600
    os.utime(orphan, (stale, stale))
    d2 = DiskTierCache(str(tmp_path))
    assert d2.orphans_removed == 1
    assert not orphan.exists()
    # the surviving entry was re-indexed (served without touching the origin)
    assert d2.get("keep") == b"payload"
    assert d2.used_bytes == len(b"payload")


def test_disk_tier_init_spares_live_writers_fresh_tmp(tmp_path):
    """Regression: on a directory shared with a LIVE process, a concurrent
    writer's fresh tmp file must not be mis-counted as a crash orphan and
    yanked out from under it mid-write."""
    fresh = tmp_path / "cafebabe.tmp999"
    fresh.write_bytes(b"another process is mid-write")
    d = DiskTierCache(str(tmp_path))
    assert d.orphans_removed == 0
    assert fresh.exists()
    # the in-flight entry is not adopted into the byte accounting either
    assert d.used_bytes == 0
    # ...but an explicit zero grace treats every tmp as orphaned (legacy)
    d2 = DiskTierCache(str(tmp_path), tmp_grace_s=0.0)
    assert d2.orphans_removed == 1 and not fresh.exists()


def test_disk_tier_init_adopts_peer_written_final_entry(tmp_path):
    """A finalized (atomically renamed) entry dropped in by another live
    process is a valid cache entry, not an orphan: re-index must count it."""
    d1 = DiskTierCache(str(tmp_path))
    d1.put("peer-key", b"peer payload")
    d2 = DiskTierCache(str(tmp_path))
    assert d2.get("peer-key") == b"peer payload"
    assert d2.used_bytes == len(b"peer payload")
    assert d2.orphans_removed == 0


def test_disk_tier_reload_respects_shrunk_capacity(tmp_path):
    d1 = DiskTierCache(str(tmp_path))
    for i in range(10):
        d1.put(f"k{i}", bytes(100))
    assert d1.used_bytes == 1000
    d2 = DiskTierCache(str(tmp_path), capacity_bytes=500)
    assert d2.used_bytes <= 500
    assert _disk_bytes(str(tmp_path)) <= 500


def test_disk_tier_write_failure_is_not_a_rejection(tmp_path, monkeypatch):
    d = DiskTierCache(str(tmp_path), capacity_bytes=1 << 20)

    def boom(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr("repro_torch.data.cache.os.replace", boom)
    assert not d.put("k", b"payload")
    s = d.stats()
    assert s.write_failures == 1 and s.rejected == 0
    assert d.used_bytes == 0  # reservation rolled back


def test_disk_tier_persistently_unreadable_entry_is_dropped(tmp_path):
    """A present-but-unreadable file must not stay pinned at MRU forever:
    after a few consecutive read failures the entry is dropped so the key
    can be refilled."""
    d = DiskTierCache(str(tmp_path), capacity_bytes=1 << 20)
    d.put("k", b"payload")
    fname = os.listdir(str(tmp_path))[0]
    p = os.path.join(str(tmp_path), fname)
    os.remove(p)
    os.mkdir(p)  # same name, unreadable as a file (IsADirectoryError)
    for _ in range(3):
        assert d.get("k") is None
    assert fname not in d._index and d.used_bytes == 0
    os.rmdir(p)
    assert d.put("k", b"payload2") and d.get("k") == b"payload2"


def test_disk_tier_unindexed_read_served_without_adoption(tmp_path):
    """A readable file with no index entry (evicted mid-read, or dropped in
    externally) is served as a hit but never (re-)indexed — adopting it
    would create a phantom entry for a possibly-unlinked file."""
    d = DiskTierCache(str(tmp_path), capacity_bytes=1 << 20)
    d.put("k", b"payload")
    fname = os.listdir(str(tmp_path))[0]
    with d._lock:  # simulate the eviction race: index dropped, file present
        entry = d._index.pop(fname)
        d._used -= entry.size
    assert d.get("k") == b"payload"
    assert d.stats().hits == 1
    assert d.used_bytes == 0 and fname not in d._index
    # the slot is genuinely writable again (no phantom fast-path)
    assert d.put("k", b"payload2")
    assert d.get("k") == b"payload2"


def test_disk_tier_vanished_file_counts_miss_and_repairs_accounting(tmp_path):
    d = DiskTierCache(str(tmp_path), capacity_bytes=1 << 20)
    d.put("k", b"payload")
    used = d.used_bytes
    # delete the entry behind the cache's back (external cleanup / crash)
    os.remove(os.path.join(str(tmp_path), os.listdir(str(tmp_path))[0]))
    assert d.get("k") is None
    assert d.stats().misses == 1
    assert d.used_bytes == used - len(b"payload")
    # the slot is reusable again
    assert d.put("k", b"payload") and d.get("k") == b"payload"


def test_disk_tier_miss_keeps_an_entry_rewritten_after_the_failed_open(tmp_path, monkeypatch):
    """A reader's open fails because the key was evicted; before the reader
    takes the lock the key is written anew. Its repair must keep the new
    entry, or the new file stays on disk outside the accounting and the
    tier holds more than its capacity."""
    import repro_torch.data.cache as cache_mod

    d = DiskTierCache(str(tmp_path), capacity_bytes=1 << 20)
    d.put("k", b"payload")
    fname = os.listdir(str(tmp_path))[0]
    real_open = open

    def open_after_evict(path, *a, **kw):
        if os.path.basename(path) == fname:
            # the open saw the evicted key; the write that follows lands
            # before this reader reaches the lock
            raise FileNotFoundError(path)
        return real_open(path, *a, **kw)

    monkeypatch.setattr(cache_mod, "open", open_after_evict, raising=False)
    assert d.get("k") is None
    monkeypatch.undo()
    assert fname in d._index and d.used_bytes == len(b"payload")
    on_disk = sum(os.path.getsize(os.path.join(str(tmp_path), f))
                  for f in os.listdir(str(tmp_path)))
    assert on_disk == d.used_bytes
    assert d.get("k") == b"payload"


# ---------------------------------------------------------------------------
# tiered facade
# ---------------------------------------------------------------------------


def _origin(n: int = 8, size: int = 100) -> InMemoryStore:
    base = InMemoryStore()
    for i in range(n):
        base.put(f"k{i}", bytes([i % 256]) * size)
    return base


def test_tiered_disk_hit_promotes_to_memory(tmp_path):
    base = _origin()
    t = TieredCacheStore(
        base,
        memory=MemoryTierCache(1 << 20),
        disk=DiskTierCache(str(tmp_path), capacity_bytes=1 << 20),
    )
    t.get("k0")  # origin fetch, written through both tiers
    assert t.memory.stats().bytes_used > 0 and t.disk.stats().bytes_used > 0
    # wipe memory: next get must come from disk and be promoted back
    t.memory.set_capacity(0)
    t.memory.set_capacity(1 << 20)
    t.get("k0")
    assert t.disk.stats().hits == 1
    t.get("k0")
    assert t.memory.stats().hits >= 1


def test_tiered_hit_rate_and_tracing(tmp_path):
    tracer = Tracer()
    t = TieredCacheStore(
        _origin(),
        memory=MemoryTierCache(1 << 20),
        disk=DiskTierCache(str(tmp_path), capacity_bytes=1 << 20),
        tracer=tracer,
    )
    t.get("k0")
    t.get("k0")
    t.get("k1")
    assert abs(t.hit_rate - 1 / 3) < 1e-9  # one of three GETs cache-served
    tiers = [s.args["tier"] for s in tracer.spans(CACHE_GET)]
    assert tiers == ["origin", "memory", "origin"]
    assert all(s.args["nbytes"] == 100 for s in tracer.spans(CACHE_GET))


def test_tiered_aget_both_tiers(tmp_path):
    base = _origin()
    t = TieredCacheStore(
        base,
        memory=MemoryTierCache(1 << 20),
        disk=DiskTierCache(str(tmp_path), capacity_bytes=1 << 20),
    )

    async def go():
        a = await t.aget("k0")  # origin
        b = await t.aget("k0")  # memory
        t.memory.set_capacity(0)
        t.memory.set_capacity(1 << 20)
        c = await t.aget("k0")  # disk
        return a, b, c

    a, b, c = asyncio.run(go())
    assert a == b == c == base.get("k0")
    assert t.disk.stats().hits == 1 and t.memory.stats().hits == 1


def test_tiered_knob_surfaces(tmp_path):
    t = TieredCacheStore(
        _origin(),
        memory=MemoryTierCache(1000),
        disk=DiskTierCache(str(tmp_path), capacity_bytes=2000),
    )
    assert t.set_memory_capacity(500) == 500
    assert t.memory.capacity == 500
    assert t.set_disk_capacity(900) == 900
    assert t.disk.capacity == 900
    assert t.admission_index() == 0
    assert t.set_admission(2) == 2
    assert t.disk.admission.name == "second-hit"
    assert t.set_admission(99) == len(ADMISSION_KINDS) - 1


def test_admission_state_survives_knob_toggles(tmp_path):
    """Second-hit's seen-set must survive autotune probe/revert toggles of
    the admission knob — a fresh Bloom filter per toggle would make the
    policy look like it never admits anything."""
    t = TieredCacheStore(
        _origin(), disk=DiskTierCache(str(tmp_path), capacity_bytes=1 << 20)
    )
    t.set_admission(2)  # second-hit
    t.get("k0")  # first sighting: recorded, not admitted
    assert t.disk.stats().admitted == 0
    t.set_admission(0)  # probe admit-all...
    t.set_admission(2)  # ...and revert: the seen-set must persist
    t.get("k0")  # origin again (not cached), but second sighting -> admitted
    assert t.disk.stats().admitted == 1
    assert t.disk.admission is t._admission_by_index[2]


def test_make_admission_rejects_unknown():
    with pytest.raises(ValueError):
        make_admission("lfu")
    assert isinstance(make_admission("admit-all"), AdmitAll)


# ---------------------------------------------------------------------------
# back-compat shims + build_store stacking
# ---------------------------------------------------------------------------


def test_legacy_shims_are_object_stores(tmp_path):
    c = CachedStore(_origin(), capacity_bytes=1 << 20)
    assert isinstance(c, ObjectStore) and isinstance(c, TieredCacheStore)
    c.get("k0"); c.get("k0")
    assert c.hits == 1 and c.misses == 1 and 0 < c.hit_rate < 1
    d = DiskCacheStore(_origin(), str(tmp_path))
    assert isinstance(d, ObjectStore)
    d.get("k0"); d.get("k0")
    assert d.hits == 1 and d.misses == 1


def test_disk_cache_store_unbounded_by_default(tmp_path):
    d = DiskCacheStore(_origin(n=4, size=1000), str(tmp_path))
    for i in range(4):
        d.get(f"k{i}")
    assert d.disk.capacity == 0 and d.disk.used_bytes == 4000


def test_build_store_two_tier_stack(tmp_path):
    cfg = StoreConfig(
        kind="s3sim", latency_mean_s=0.0, cache_bytes=1 << 20,
        cache_dir=str(tmp_path), disk_cache_bytes=1 << 20,
        cache_admission="size-threshold", admission_max_item_bytes=50,
    )
    base = InMemoryStore()
    base.put("small", bytes(10))
    base.put("large", bytes(100))
    st = build_store(cfg, base=base)
    assert isinstance(st, TieredCacheStore)
    assert isinstance(st.base, SimulatedS3Store)
    st.get("small"); st.get("large")
    assert st.disk.stats().admitted == 1  # large rejected by size threshold
    assert st.disk.stats().rejected == 1
    stats = st.cache_stats()
    assert set(stats) == {"memory", "disk"}


# ---------------------------------------------------------------------------
# autotune integration
# ---------------------------------------------------------------------------


def _tiered_dataset(tmp_path, n_items=96, mem_cap=1 << 14, disk_cap=1 << 20):
    store = SyntheticImageStore(n_items, seed=0, avg_kb=4)
    sim = SimulatedS3Store(store, latency_mean_s=0.003, bandwidth_per_conn=1e9,
                           max_connections=64)
    tiered = TieredCacheStore(
        sim,
        memory=MemoryTierCache(mem_cap, shards=4),
        disk=DiskTierCache(str(tmp_path), capacity_bytes=disk_cap),
    )
    return ImageDataset(tiered, n_items, out_size=24), tiered


def test_build_cache_knobs_bounds_and_names(tmp_path):
    _, tiered = _tiered_dataset(tmp_path, mem_cap=1 << 14, disk_cap=1 << 20)
    # without an explicit growth ceiling there is no capacity knob: the
    # controller must never silently grow a user-sized cache, and a knob
    # pinned at its upper wall would be a silent no-op
    cfg = AutotuneConfig(enabled=True)
    knobs = {k.name: k for k in build_cache_knobs(cfg, tiered)}
    assert set(knobs) == {"cache_admission"}
    assert knobs["cache_admission"].scale == "add"
    assert knobs["cache_admission"].hi == len(ADMISSION_KINDS) - 1
    # explicit ceilings above the configured capacities opt in to growth
    cfg2 = AutotuneConfig(enabled=True, max_memory_cache_bytes=1 << 22,
                          max_disk_cache_bytes=1 << 24)
    knobs2 = {k.name: k for k in build_cache_knobs(cfg2, tiered)}
    assert set(knobs2) == {"cache_mem_bytes", "cache_disk_bytes",
                           "cache_admission"}
    assert knobs2["cache_mem_bytes"].lo <= 1 << 14 < knobs2["cache_mem_bytes"].hi == 1 << 22
    assert knobs2["cache_disk_bytes"].lo <= 1 << 20 < knobs2["cache_disk_bytes"].hi == 1 << 24
    # an unbounded disk tier exposes no capacity knob even with a ceiling
    tiered.disk.capacity = 0
    names = {k.name for k in build_cache_knobs(cfg2, tiered)}
    assert "cache_disk_bytes" not in names


def test_build_store_wires_tracer_for_cache_spans(tmp_path):
    tracer = Tracer()
    cfg = StoreConfig(kind="s3sim", latency_mean_s=0.0, cache_bytes=1 << 20,
                      cache_dir=str(tmp_path), disk_cache_bytes=1 << 20)
    base = InMemoryStore()
    base.put("k", bytes(100))
    st = build_store(cfg, base=base, tracer=tracer)
    st.get("k")
    st.get("k")
    tiers = [s.args["tier"] for s in tracer.spans(CACHE_GET)]
    assert tiers == ["origin", "memory"]
    # the loader never rebinds a shared store's tracer to its own
    ds, tiered = _tiered_dataset(tmp_path / "ldr")
    other = Tracer()
    dl = ConcurrentDataLoader(
        ds, LoaderConfig(impl="threaded", batch_size=16, num_workers=2,
                         prefetch_factor=2, num_fetch_workers=4, seed=2),
        tracer=other)
    list(dl)
    assert tiered.tracer is not other and not other.spans(CACHE_GET)


def test_loader_attaches_cache_knobs(tmp_path):
    ds, _ = _tiered_dataset(tmp_path)
    at = AutotuneConfig(enabled=True, interval_batches=1, min_window_s=0.0,
                        max_memory_cache_bytes=1 << 22,
                        max_disk_cache_bytes=1 << 24)
    cfg = LoaderConfig(impl="threaded", batch_size=16, num_workers=2,
                       prefetch_factor=2, num_fetch_workers=4, seed=7,
                       autotune=at)
    dl = ConcurrentDataLoader(ds, cfg)
    it = iter(dl)
    names = {k.name for k in dl.autotuner.knobs}
    assert {"cache_mem_bytes", "cache_disk_bytes", "cache_admission"} <= names
    it.shutdown()
    # tune_cache=False leaves the cache alone
    dl2 = ConcurrentDataLoader(
        ds, LoaderConfig(impl="threaded", batch_size=16, seed=7,
                         autotune=AutotuneConfig(enabled=True, tune_cache=False)))
    it2 = iter(dl2)
    assert not any(k.name.startswith("cache_") for k in dl2.autotuner.knobs)
    it2.shutdown()


def test_cache_capacity_moves_never_change_delivery_order(tmp_path):
    """Autotuned cache-capacity/admission moves must not perturb the
    delivered stream: same batches, same order, as the static loader."""
    def digest(batches):
        return [(float(b["image"].sum()), b["label"].tolist()) for b in batches]

    cfg_kw = dict(impl="threaded", batch_size=16, num_workers=2,
                  prefetch_factor=2, num_fetch_workers=8, seed=11)
    ds_a, _ = _tiered_dataset(tmp_path / "a")
    stock = digest(list(ConcurrentDataLoader(ds_a, LoaderConfig(**cfg_kw))))
    # pin the loader knobs so ONLY the cache knobs can move; explicit max
    # bytes opt the capacity knobs into growth so they genuinely probe
    at = AutotuneConfig(enabled=True, interval_batches=1, min_window_s=0.0,
                        warmup_windows=0,
                        min_fetch_workers=8, max_fetch_workers=8,
                        min_outstanding=4, max_outstanding=4,
                        max_memory_cache_bytes=1 << 22,
                        max_disk_cache_bytes=1 << 24)
    ds_b, tiered_b = _tiered_dataset(tmp_path / "b")
    dl = ConcurrentDataLoader(ds_b, LoaderConfig(autotune=at, **cfg_kw))
    tuned = digest(list(dl))
    tuned += digest(list(dl))  # second pass: warm tiers + learned knobs
    assert tuned[: len(stock)] == stock
    moved = [e for e in dl.autotuner.events
             if e.action == "probe" and e.knob.startswith("cache_")]
    assert moved, "no cache knob was ever probed"


def test_autotuned_controller_drives_real_cache(tmp_path):
    """Controller moves applied to a real TieredCacheStore keep every
    invariant: capacities within knob bounds, disk bytes within capacity."""
    _, tiered = _tiered_dataset(tmp_path, mem_cap=1 << 14, disk_cap=1 << 18)
    cfg = AutotuneConfig(enabled=True, interval_batches=1, min_window_s=0.0,
                         patience=1000, max_memory_cache_bytes=1 << 22,
                         max_disk_cache_bytes=1 << 24)
    knobs = build_cache_knobs(cfg, tiered)
    ctrl = AutotuneController(cfg, knobs)
    # adversarial deterministic profile provokes accepts/reverts everywhere
    now = [0.0]

    def tick():
        vals = (tiered.memory.capacity, tiered.disk.capacity,
                tiered.admission_index())
        tput = 1.0 + (hash(vals) % 97)
        now[0] += 1.0 / tput
        ctrl.on_batch(1, now=now[0])

    for _ in range(300):
        tick()
    by_name = {k.name: k for k in knobs}
    assert (by_name["cache_mem_bytes"].lo <= tiered.memory.capacity
            <= by_name["cache_mem_bytes"].hi)
    assert (by_name["cache_disk_bytes"].lo <= tiered.disk.capacity
            <= by_name["cache_disk_bytes"].hi)
    assert 0 <= tiered.admission_index() < len(ADMISSION_KINDS)


def test_tiered_cache_under_loader_stays_bounded(tmp_path):
    """End-to-end: a threaded loader hammering a small two-tier cache never
    pushes the disk tier over its byte bound."""
    cap = 48 * 1024
    ds, tiered = _tiered_dataset(tmp_path, mem_cap=16 * 1024, disk_cap=cap)
    cfg = LoaderConfig(impl="threaded", batch_size=16, num_workers=2,
                       prefetch_factor=2, num_fetch_workers=8, seed=3)
    dl = ConcurrentDataLoader(ds, cfg)
    peak = [0]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            try:
                peak[0] = max(peak[0], _disk_bytes(str(tmp_path)))
            except OSError:
                pass
            time.sleep(0.001)

    s = threading.Thread(target=sample)
    s.start()
    for _ in dl:
        pass
    stop.set()
    s.join()
    assert peak[0] <= cap
    assert tiered.disk.used_bytes <= cap


# -- TinyLFU admission -------------------------------------------------------


def test_tinylfu_rejects_one_touch_admits_repeats(tmp_path):
    d = DiskTierCache(
        str(tmp_path), capacity_bytes=1 << 20, admission=TinyLFUAdmission()
    )
    assert not d.put("k", b"x")  # first sighting: freq 1 < threshold
    assert d.get("k") is None
    assert d.put("k", b"x")  # second sighting: freq 2 -> admitted
    assert d.get("k") == b"x"
    # a one-touch scan over fresh keys admits nothing
    for i in range(50):
        assert not d.put(f"scan/{i}", b"y")


def test_tinylfu_hits_feed_the_sketch(tmp_path):
    pol = TinyLFUAdmission()
    d = DiskTierCache(str(tmp_path), capacity_bytes=1 << 20, admission=pol)
    d.put("k", b"x"), d.put("k", b"x")  # admitted on the second miss
    before = pol.estimate("k")
    for _ in range(3):
        assert d.get("k") == b"x"  # each hit records into the sketch
    assert pol.estimate("k") >= before + 3


def test_tinylfu_aging_decays_stale_frequency():
    pol = TinyLFUAdmission(sample_window=20)
    for _ in range(4):
        pol.record("hot")
    assert pol.estimate("hot") >= 4
    for i in range(40):  # two full aging windows of other traffic
        pol.record(f"noise/{i}")
    # halved twice: the stale key must re-prove itself
    assert pol.estimate("hot") <= 2


def test_tinylfu_selectable_everywhere(tmp_path):
    assert "tinylfu" in ADMISSION_KINDS
    assert isinstance(make_admission("tinylfu"), TinyLFUAdmission)
    # via StoreConfig/build_store
    base = InMemoryStore()
    base.put("a", bytes(50))
    store = build_store(
        StoreConfig(kind="memory", cache_dir=str(tmp_path),
                    disk_cache_bytes=1 << 20, cache_admission="tinylfu"),
        base=base,
    )
    assert isinstance(store.disk.admission, TinyLFUAdmission)
    store.get("a"), store.get("a")
    # and the autotune admission index covers it
    tiered = TieredCacheStore(base, disk=DiskTierCache(str(tmp_path / "t")))
    at = AutotuneConfig(enabled=True)
    knobs = [k for k in build_cache_knobs(at, tiered) if k.name == "cache_admission"]
    assert knobs and knobs[0].hi == len(ADMISSION_KINDS) - 1
    assert tiered.set_admission(knobs[0].hi) == ADMISSION_KINDS.index("tinylfu")
    assert tiered.disk.admission.name == "tinylfu"


# ---------------------------------------------------------------------------
# twin of tests/test_config_api.py::TestCacheConfigNesting
# ---------------------------------------------------------------------------


class TestCacheConfigNesting:
    def test_nested_construction_warns_nothing(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cfg = StoreConfig(cache=CacheConfig(
                memory_bytes=1 << 20, dir="/tmp/c", disk_bytes=1 << 22,
                shards=4, admission="second_hit",
            ))
        assert cfg.cache.memory_bytes == 1 << 20
        assert cfg.cache.admission == "second_hit"

    def test_legacy_read_properties_delegate(self):
        cfg = StoreConfig(cache=CacheConfig(
            memory_bytes=123, dir="/tmp/c", disk_bytes=456, shards=2,
            admission="always", admission_max_item_bytes=789,
            coord="file", coord_host_id=1, coord_num_hosts=4,
        ))
        assert cfg.cache_bytes == 123
        assert cfg.cache_dir == "/tmp/c"
        assert cfg.disk_cache_bytes == 456
        assert cfg.cache_shards == 2
        assert cfg.cache_admission == "always"
        assert cfg.admission_max_item_bytes == 789
        assert cfg.cache_coord == "file"
        assert cfg.cache_coord_host_id == 1
        assert cfg.cache_coord_num_hosts == 4

    def test_replace_round_trips_without_warning(self):
        cfg = StoreConfig(cache=CacheConfig(memory_bytes=1 << 20))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            derived = replace(cfg, kind="memory")
        assert derived.cache == cfg.cache
        assert derived.kind == "memory"

    @pytest.mark.parametrize("flat,nested,value", [
        ("cache_bytes", "memory_bytes", 1 << 20),
        ("cache_dir", "dir", "/tmp/cache"),
        ("disk_cache_bytes", "disk_bytes", 1 << 22),
        ("cache_shards", "shards", 8),
        ("cache_admission", "admission", "second_hit"),
        ("admission_max_item_bytes", "admission_max_item_bytes", 4096),
        ("cache_coord", "coord", "file"),
        ("cache_coord_host_id", "coord_host_id", 2),
        ("cache_coord_num_hosts", "coord_num_hosts", 4),
    ])
    def test_each_flat_kwarg_warns_once_and_lands_nested(self, flat, nested,
                                                         value):
        with pytest.warns(DeprecationWarning, match=flat) as rec:
            cfg = StoreConfig(**{flat: value})
        assert sum(issubclass(w.category, DeprecationWarning)
                   for w in rec) == 1
        assert getattr(cfg.cache, nested) == value

    def test_flat_equals_nested(self):
        with pytest.warns(DeprecationWarning):
            flat = StoreConfig(cache_bytes=1 << 20, cache_dir="/tmp/c",
                               disk_cache_bytes=1 << 22)
        nested = StoreConfig(cache=CacheConfig(
            memory_bytes=1 << 20, dir="/tmp/c", disk_bytes=1 << 22))
        assert flat == nested

    def test_flat_kwargs_merge_into_given_cache(self):
        with pytest.warns(DeprecationWarning, match="cache_bytes"):
            cfg = StoreConfig(
                cache=CacheConfig(dir="/tmp/c", shards=2),
                cache_bytes=1 << 20,
            )
        assert cfg.cache.memory_bytes == 1 << 20
        assert cfg.cache.dir == "/tmp/c"
        assert cfg.cache.shards == 2
