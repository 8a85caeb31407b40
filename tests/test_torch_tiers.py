"""The port's tracer export and cache tiers held against the reference's on
the same inputs, made from a numpy seed: the same spans give equal Chrome
traces; the same get sequence through both ``TieredCacheStore`` stacks
(memory over disk, each admission kind) serves from the same tiers, evicts
the same victims and ends with equal ``cache_stats()``; a disk-tier
directory written by either package is reopened by the other (journal and
shard modes); and the loader over a two-tier cache, with the cache knobs
on an epoch-cadence controller, yields the reference loader's stream.
Every comparison is exact."""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.coord as jcoord  # noqa: E402
import repro.data.cache as jcache  # noqa: E402
from repro.config import AutotuneConfig as JaxAutotuneConfig  # noqa: E402
from repro.config import LoaderConfig as JaxLoaderConfig  # noqa: E402
from repro.core.loader import ConcurrentDataLoader as JaxLoader  # noqa: E402
from repro.core.tracing import Tracer as JaxTracer  # noqa: E402
from repro.data.dataset import ImageDataset as JaxImageDataset  # noqa: E402
from repro.data.imagenet_synth import SyntheticImageStore as JaxSynth  # noqa: E402
from repro.data.store import InMemoryStore as JaxMemoryStore  # noqa: E402
from repro.data.store import SimulatedS3Store as JaxS3  # noqa: E402
import repro_torch.core.coord as tcoord  # noqa: E402
import repro_torch.data.cache as tcache  # noqa: E402
from repro_torch.config import AutotuneConfig, LoaderConfig  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.tracing import CACHE_GET, Tracer  # noqa: E402
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore  # noqa: E402
from repro_torch.data.store import InMemoryStore, SimulatedS3Store  # noqa: E402

SIDES = {"reference": (jcache, jcoord, JaxMemoryStore, JaxTracer),
         "port": (tcache, tcoord, InMemoryStore, Tracer)}


# ---------------------------------------------------------------------------
# tracer: the Chrome-trace export
# ---------------------------------------------------------------------------


def test_same_spans_give_equal_chrome_traces(tmp_path):
    rng = np.random.default_rng(5)
    names = ["get_batch", "get_item", "batch_to_device", "run_training_batch", CACHE_GET]
    spans = []
    for i in range(64):
        t0 = float(rng.uniform(0, 100))
        spans.append((names[int(rng.integers(len(names)))], t0,
                      t0 + float(rng.exponential(0.01)),
                      int(rng.integers(0, 1 << 48)),
                      {"tier": ["memory", "disk", "origin"][i % 3], "nbytes": int(i * 17),
                       "ratio": float(rng.uniform())}))
    traces = {}
    for side, (_, _, _, tracer_cls) in SIDES.items():
        tr = tracer_cls()
        for name, t0, t1, tid, args in spans:
            tr.record(name, t0, t1, tid=tid, **args)
        path = tmp_path / f"{side}.json"
        tr.dump(str(path))
        traces[side] = (tr.to_chrome_trace(), json.loads(path.read_text()))
        tr.clear()
        assert tr.spans() == [] and tr.to_chrome_trace() == {"traceEvents": []}
    assert traces["port"] == traces["reference"]
    events = traces["port"][0]["traceEvents"]
    assert len(events) == 64 and {e["ph"] for e in events} == {"X"}
    assert all(0 <= e["tid"] < 1_000_000 for e in events)


# ---------------------------------------------------------------------------
# the tiered store: same gets, same tiers, victims and stats
# ---------------------------------------------------------------------------


def _origin(mem_cls, sizes):
    base = mem_cls()
    for i, n in enumerate(sizes):
        base.put(f"img/{i:05d}", bytes([i % 251]) * int(n))
    return base


def _contents(store):
    mem = [k for sh in store.memory._shards for k in sh.lru]
    disk = list(store.disk._index)
    return mem, disk


@pytest.mark.parametrize("kind", tcache.ADMISSION_KINDS)
def test_same_gets_serve_from_the_same_tiers_as_the_reference(tmp_path, kind):
    assert tcache.ADMISSION_KINDS == jcache.ADMISSION_KINDS
    rng = np.random.default_rng(11)
    sizes = rng.integers(200, 3000, 40)
    # a skewed key stream (repeats for the memory tier, a long tail that
    # evicts from both tiers) and a few origin writes between gets
    keys = [f"img/{int(min(rng.zipf(1.3), 40)) - 1:05d}" for _ in range(400)]
    trails = {}
    for side, (cache, _, mem_cls, tracer_cls) in SIDES.items():
        tracer = tracer_cls()
        store = cache.TieredCacheStore(
            _origin(mem_cls, sizes),
            memory=cache.MemoryTierCache(8_000),
            disk=cache.DiskTierCache(str(tmp_path / side), 20_000,
                                     cache.make_admission(kind, 2_000)),
            tracer=tracer, admission_max_item_bytes=2_000)
        served, victims, before = [], [], _contents(store)
        for i, k in enumerate(keys):
            if i % 97 == 96:
                store.put(k, b"w" * 500)  # origin write: the tiers keep the old bytes
            data = store.get(k)
            served.append((len(data), data[:1]))
            after = _contents(store)
            victims.append((sorted(set(before[0]) - set(after[0])),
                            sorted(set(before[1]) - set(after[1]))))
            before = after
        tiers = [s.args["tier"] for s in tracer.spans(CACHE_GET)]
        stats = {t: dataclasses.asdict(s) for t, s in store.cache_stats().items()}
        files = sorted(f for f in os.listdir(tmp_path / side) if not f.startswith("."))
        trails[side] = (served, tiers, victims, before, stats, store.hit_rate, files)
    ref, port = trails["reference"], trails["port"]
    for i, what in enumerate(("bytes served", "tier per get", "victims per get",
                              "final contents", "cache_stats", "hit rate", "disk files")):
        assert port[i] == ref[i], what
    tiers = port[1]
    assert {"memory", "origin"} <= set(tiers)  # both tiers and the origin served
    assert any(ev[0] for ev in port[2]), "no memory eviction: the stream is too short"
    if kind == "admit-all":
        assert any(ev[1] for ev in port[2]), "no disk eviction: the stream is too short"


# ---------------------------------------------------------------------------
# the disk tier's directory: written by one package, reopened by the other
# ---------------------------------------------------------------------------


def _items(seed, n=24):
    rng = np.random.default_rng(seed)
    return {f"item/{i:04d}": rng.integers(0, 256, int(rng.integers(100, 900)),
                                         dtype=np.uint8).tobytes() for i in range(n)}


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if not f.startswith(".") and ".tmp" not in f)


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_journal_mode_directory_is_read_by_the_other_package(tmp_path, writer, reader):
    items = _items(3)
    d, cap = str(tmp_path / "disk"), 1 << 20
    wcache, wcoord = SIDES[writer][:2]
    tier = wcache.DiskTierCache(d, cap, journal=wcoord.SharedDiskJournal(d, cap))
    for k, v in items.items():
        assert tier.put(k, v)
    rcache, rcoord = SIDES[reader][:2]
    journal = rcoord.SharedDiskJournal(d, cap)
    # the reader's journal replays the writer's log: the same entries, and
    # a byte total equal to the entry files on disk
    assert journal.entry_count() == len(items)
    assert journal.used_bytes() == sum(map(len, items.values())) == _dir_bytes(d)
    again = rcache.DiskTierCache(d, cap, journal=journal)
    assert {k: again.get(k) for k in items} == items
    assert again.stats().hits == len(items) and again.stats().misses == 0
    # and it keeps accounting in the same journal: a new entry from the
    # reader is seen by a fresh writer-side journal
    assert again.put("item/new", b"n" * 321)
    assert wcoord.SharedDiskJournal(d, cap).used_bytes() == _dir_bytes(d)


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_shard_mode_directory_is_read_by_the_other_package(tmp_path, writer, reader):
    items = _items(4)
    d, cap, n = str(tmp_path / "disk"), 1 << 20, 2
    wcache = SIDES[writer][0]
    hosts = [wcache.DiskTierCache(d, cap, shard=(h, n)) for h in range(n)]
    owner = {k: tcoord.host_shard(k, n) for k in items}
    assert owner == {k: jcoord.host_shard(k, n) for k in items}
    for k, v in items.items():
        assert hosts[owner[k]].put(k, v)
    rcache = SIDES[reader][0]
    for h in range(n):
        again = rcache.DiskTierCache(d, cap, shard=(h, n))
        # re-indexing adopts only this host's shard, as the writer accounted it
        assert again.used_bytes == hosts[h].used_bytes == sum(
            len(v) for k, v in items.items() if owner[k] == h)
        # and every key reads back, its own shard's and its peer's
        assert {k: again.get(k) for k in items} == items
        assert again.stats().shard_foreign == 0


def test_disk_file_names_are_the_references(tmp_path):
    for shard in (None, (1, 3)):
        kw = {} if shard is None else {"shard": shard}
        t = tcache.DiskTierCache(str(tmp_path / "t"), **kw)
        j = jcache.DiskTierCache(str(tmp_path / "j"), **kw)
        keys = [f"img/{i}" for i in range(50)] + ["", "a/b/c", "é"]
        assert [t._fname(k) for k in keys] == [j._fname(k) for k in keys]


# ---------------------------------------------------------------------------
# the loader over a two-tier cache with epoch-cadence cache tuning
# ---------------------------------------------------------------------------

N_ITEMS, BS, EPOCHS = 48, 8, 4


def test_epoch_cadence_cache_tuning_yields_the_reference_stream(tmp_path):
    at = dict(enabled=True, interval_batches=2, min_window_s=0.0, cache_cadence="epoch",
              cache_epoch_windows=1, max_memory_cache_bytes=1 << 20,
              max_disk_cache_bytes=1 << 22)
    cfg = dict(impl="threaded", batch_size=BS, num_workers=2, prefetch_factor=2,
               num_fetch_workers=4, seed=3)
    sides = {
        "reference": (jcache, JaxSynth, JaxS3, JaxImageDataset, JaxLoader,
                      JaxLoaderConfig(**cfg, autotune=JaxAutotuneConfig(**at))),
        "port": (tcache, SyntheticImageStore, SimulatedS3Store, ImageDataset,
                 ConcurrentDataLoader, LoaderConfig(**cfg, autotune=AutotuneConfig(**at))),
    }
    streams, loaders = {}, {}
    for side, (cache, synth, s3, ds_cls, loader_cls, lcfg) in sides.items():
        origin = s3(synth(N_ITEMS, seed=0, avg_kb=2), latency_mean_s=0.001,
                    bandwidth_per_conn=1e9, max_connections=64)
        tiered = cache.TieredCacheStore(
            origin, memory=cache.MemoryTierCache(16 << 10),
            disk=cache.DiskTierCache(str(tmp_path / side), 256 << 10))
        loader = loader_cls(ds_cls(tiered, N_ITEMS, out_size=16), lcfg)
        out = []
        for epoch in range(EPOCHS):
            if epoch:
                loader.set_epoch(epoch)
            out.append(list(loader))
        loader.release_coordination()
        streams[side], loaders[side] = out, loader
    for e, (pe, re_) in enumerate(zip(streams["port"], streams["reference"])):
        assert len(pe) == len(re_) == N_ITEMS // BS
        for pb, rb in zip(pe, re_):
            assert sorted(pb) == sorted(rb)
            for k in rb:
                np.testing.assert_array_equal(pb[k], rb[k], err_msg=f"epoch {e} {k}")
    port = loaders["port"]
    # the cache knobs live on the epoch controller, which was fed once per
    # epoch and probed; the per-batch controller has none
    assert {k.name for k in port.cache_autotuner.knobs} == {
        k.name for k in loaders["reference"].cache_autotuner.knobs} >= {"cache_mem_bytes"}
    assert all("cache" not in k.name for k in port.autotuner.knobs)
    assert any(e.action == "probe" for e in port.cache_autotuner.events)
