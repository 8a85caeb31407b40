"""Twins of ``tests/test_store.py`` on the port alone (the s3sim latency,
bandwidth and failure models, the in-memory and local-file stores, the
in-memory cache and the store stack), the same cases and assertions with
the imports pointed at ``repro_torch``."""
import threading
import time

import numpy as np
import pytest
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # bare interpreter: skip only the property-based tests
    from _hypothesis_fallback import given, settings, st

pytest.importorskip("torch")

from repro_torch.config import StoreConfig  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore, item_key  # noqa: E402
from repro_torch.data.store import (  # noqa: E402
    CachedStore,
    InMemoryStore,
    KeyNotFound,
    LocalFSStore,
    SimulatedS3Store,
    TransientStoreError,
    build_store,
)


def test_inmemory_roundtrip():
    s = InMemoryStore()
    s.put("a/b", b"hello")
    assert s.get("a/b") == b"hello"
    assert s.size("a/b") == 5
    assert s.list_keys("a/") == ["a/b"]
    with pytest.raises(KeyNotFound):
        s.get("missing")


def test_localfs_roundtrip(tmp_path):
    s = LocalFSStore(str(tmp_path))
    s.put("x/y.bin", b"\x00\x01\x02")
    assert s.get("x/y.bin") == b"\x00\x01\x02"
    assert s.list_keys() == ["x/y.bin"]
    assert s.size("x/y.bin") == 3
    with pytest.raises(KeyNotFound):
        s.get("nope")


def test_synthetic_store_deterministic():
    s1 = SyntheticImageStore(8, seed=3)
    s2 = SyntheticImageStore(8, seed=3)
    k = item_key(5)
    assert s1.get(k) == s2.get(k)
    assert SyntheticImageStore(8, seed=4).get(k) != s1.get(k)
    with pytest.raises(KeyNotFound):
        s1.get(item_key(8))  # out of range


def test_synthetic_store_size_distribution():
    s = SyntheticImageStore(64, seed=0, avg_kb=115.0)
    sizes = [s.size(k) for k in s.list_keys()]
    mean_kb = np.mean(sizes) / 1024
    assert 60 < mean_kb < 220  # lognormal around 115 kB


def test_s3sim_latency_is_simulated():
    base = InMemoryStore()
    base.put("k", b"x" * 1000)
    sim = SimulatedS3Store(base, latency_mean_s=0.05, latency_sigma=0.0,
                           bandwidth_per_conn=1e9)
    t0 = time.monotonic()
    sim.get("k")
    assert time.monotonic() - t0 >= 0.04
    assert sim.stats.gets == 1 and sim.stats.bytes_read == 1000


def test_s3sim_deterministic_given_seed():
    base = InMemoryStore()
    base.put("k", b"x")
    a = SimulatedS3Store(base, latency_mean_s=0.001, seed=1)
    b = SimulatedS3Store(base, latency_mean_s=0.001, seed=1)
    assert a._sample("k", 100) == b._sample("k", 100)  # same attempt counter


def test_s3sim_bandwidth_model():
    base = InMemoryStore()
    base.put("big", b"x" * 10_000_000)
    sim = SimulatedS3Store(base, latency_mean_s=0.0, latency_sigma=0.0,
                           bandwidth_per_conn=100e6)
    t0 = time.monotonic()
    sim.get("big")
    # 10 MB at 100 MB/s = 0.1 s
    assert time.monotonic() - t0 >= 0.08


def test_s3sim_concurrency_helps():
    """Within-batch parallelism premise: N concurrent GETs ≪ N sequential."""
    base = SyntheticImageStore(32, seed=0, avg_kb=2)
    sim = SimulatedS3Store(base, latency_mean_s=0.02, bandwidth_per_conn=1e9,
                           max_connections=32)
    keys = base.list_keys()
    t0 = time.monotonic()
    for k in keys[:16]:
        sim.get(k)
    seq = time.monotonic() - t0
    threads = [threading.Thread(target=sim.get, args=(k,)) for k in keys[16:]]
    t0 = time.monotonic()
    [t.start() for t in threads]
    [t.join() for t in threads]
    par = time.monotonic() - t0
    assert par < seq / 2


def test_s3sim_failure_injection_and_stats():
    base = InMemoryStore()
    base.put("k", b"x")
    sim = SimulatedS3Store(base, latency_mean_s=0.0, failure_rate=1.0)
    with pytest.raises(TransientStoreError):
        sim.get("k")
    assert sim.stats.failures == 1


def test_cache_lru_eviction_and_hits():
    base = InMemoryStore()
    for i in range(4):
        base.put(f"k{i}", bytes([i]) * 100)
    c = CachedStore(base, capacity_bytes=250)  # fits 2 items
    c.get("k0"); c.get("k1"); c.get("k2")  # k0 evicted
    assert c.misses == 3 and c.hits == 0
    c.get("k2"); c.get("k1")
    assert c.hits == 2
    c.get("k0")  # miss again (was evicted)
    assert c.misses == 4


def test_cache_respects_item_larger_than_capacity():
    base = InMemoryStore()
    base.put("big", b"z" * 1000)
    c = CachedStore(base, capacity_bytes=10)
    assert c.get("big") == b"z" * 1000
    assert c._used == 0


def test_build_store_stack():
    cfg = StoreConfig(kind="s3sim", latency_mean_s=0.0, cache_bytes=1 << 20)
    base = InMemoryStore()
    base.put("k", b"v")
    st_ = build_store(cfg, base=base)
    assert st_.get("k") == b"v"
    assert isinstance(st_, CachedStore)
    assert isinstance(st_.base, SimulatedS3Store)


@given(st.binary(min_size=0, max_size=2048), st.text(
    alphabet=st.characters(whitelist_categories=("Ll", "Nd")), min_size=1, max_size=32))
@settings(max_examples=25, deadline=None)
def test_store_roundtrip_property(data, key):
    s = InMemoryStore()
    s.put(key, data)
    assert s.get(key) == data
    assert s.size(key) == len(data)
