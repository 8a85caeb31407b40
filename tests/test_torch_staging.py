"""Pinned host staging (``repro_torch.core.staging``) and the device prefetch
ring's use of it.

On the CPU: the port's ``HostBatchPool`` gives the reference's ``stats()``
and bytes for the same lease, release and detach sequence; a lease whose
transfer result aliases the buffers (``.to("cpu")`` returns the same
storage) is detached, never pooled; a CPU consumer pins nothing, even where
a card is present; ``StagedBatch.pin`` registers each pooled set once and
every registered allocation is unregistered when it is freed (against a
stand-in for the CUDA runtime); the ring releases staged batches and runs
the ingest epilogue.  On the card (``-m cuda``): the ring copies H2D
straight from the pool's buffers pinned in place and reuses them, sets are
registered, dropped and collected in a loop with no error, and a ring that
released a buffer before its copy landed is seen.
"""
import gc
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.staging import HostBatchPool as JaxHostBatchPool  # noqa: E402
from repro.data.dataset import collate as jax_collate  # noqa: E402
from repro_torch.config import LoaderConfig, PipelineConfig  # noqa: E402
from repro_torch.core import make_loader  # noqa: E402
from repro_torch.core.prefetch import DevicePrefetchRing  # noqa: E402
from repro_torch.core.staging import (  # noqa: E402
    PAGE,
    HostBatchPool,
    StagedBatch,
    buffers_aliased,
)
from repro_torch.core.tracing import BATCH_TO_DEVICE, Tracer  # noqa: E402
from repro_torch.data.dataset import ImageDataset, collate  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore  # noqa: E402
from repro_torch.data.store import SimulatedS3Store  # noqa: E402
from repro_torch.kernels.ingest_norm.ops import make_ingest_fn  # noqa: E402

N_ITEMS = 64
BS = 8


def _items(n, seed, shape=(3, 4)):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 255, shape, dtype=np.uint8),
             "label": np.int32(rng.integers(0, 1000)),
             "nbytes": np.int64(rng.integers(1, 1 << 20))} for _ in range(n)]


def test_same_lease_sequence_gives_reference_stats_and_bytes():
    """Lease, release, double release, past-depth (ephemeral), detach, a
    second layout and a GC-released lease: after every step both pools
    report the same stats, and every batch holds np.stack-collate's bytes."""
    port, ref = HostBatchPool(depth=2), JaxHostBatchPool(depth=2)
    live = {}

    def lease(name, items):
        got, want = port.collate(items), ref.collate(items)
        assert isinstance(got, StagedBatch)
        for k, v in collate(items).items():
            np.testing.assert_array_equal(got[k], v)
            np.testing.assert_array_equal(want[k], v)
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].ctypes.data % PAGE == 0
        np.testing.assert_array_equal(jax_collate(items)["image"], got["image"])
        live[name] = (got, want)

    def both(name, op):
        for b in live[name]:
            getattr(b, op)()

    steps = [
        lambda: lease("a", _items(BS, 0)),
        lambda: lease("b", _items(BS, 1)),
        lambda: lease("c", _items(BS, 2)),  # past depth: ephemeral
        lambda: both("a", "release"),
        lambda: both("a", "release"),  # idempotent
        lambda: lease("d", _items(BS, 3)),  # reuses a's set
        lambda: both("b", "detach"),
        lambda: both("c", "release"),  # the free list has room: kept
        lambda: lease("e", _items(BS, 4)),  # reuses c's set
        lambda: lease("f", _items(4, 5, shape=(2, 2, 3))),  # a second bucket
        lambda: live.pop("f"),  # never released: GC returns it
        gc.collect,
        lambda: lease("g", _items(4, 6, shape=(2, 2, 3))),  # reuses f's set
    ]
    for i, step in enumerate(steps):
        step()
        assert port.stats() == ref.stats(), f"after step {i}"
    assert port.stats() == {"depth": 2, "buckets": 2, "leases": 7, "reuses": 3,
                            "allocs": 3, "ephemeral": 1, "detached": 1}
    assert port.registered == 0  # no CUDA consumer pinned anything


def test_cpu_alias_is_detached_never_pooled():
    pool = HostBatchPool(depth=1)
    a = pool.collate(_items(BS, 0))
    assert a.pooled and a["image"].ctypes.data % PAGE == 0
    dev = {k: torch.from_numpy(v).to("cpu") for k, v in a.items()}
    assert buffers_aliased(dev, a)  # .to("cpu") returned the storage itself
    a.release_after(dev)
    assert pool.stats()["detached"] == 1
    b = pool.collate(_items(BS, 1))  # a fresh set: the aliased one is gone
    assert pool.stats()["allocs"] == 2 and pool.stats()["reuses"] == 0
    # the detached buffers still hold a's bytes under the "device" batch
    np.testing.assert_array_equal(dev["image"].numpy(), collate(_items(BS, 0))["image"])
    # a real copy recycles
    copied = {k: torch.from_numpy(v).clone() for k, v in b.items()}
    assert not buffers_aliased(copied, b)
    b.release_after(copied)
    pool.collate(_items(BS, 2))
    assert pool.stats()["reuses"] == 1 and pool.stats()["detached"] == 1


class FakeCudart:
    """Stands in for ``torch.cuda.cudart()``: keeps the registered ranges and
    refuses what the CUDA runtime refuses (a range registered twice, an
    unregister of memory that is not registered)."""

    class cudaError:
        success = 0

    def __init__(self):
        self.live = {}
        self.registers = 0

    def cudaHostRegister(self, ptr, nbytes, flags):
        if ptr in self.live or ptr % PAGE:
            return 1
        self.live[ptr] = nbytes
        self.registers += 1
        return 0

    def cudaHostUnregister(self, ptr):
        return 0 if self.live.pop(ptr, None) is not None else 1

    def cudaGetErrorString(self, err):
        return f"error {err}"


def test_pin_registers_each_pooled_set_once_and_unregisters_it_when_freed(monkeypatch):
    """The lifetime rule of pinning in place, against a stand-in runtime: a
    pooled set is registered the first time it is pinned and not again on
    reuse; a lease past depth is copied by ``.pin_memory()`` and never
    registered; every registered allocation is unregistered once, when its
    memory is freed (a detached set's, once the result that aliased it is
    gone; the pool's, when the pool is)."""
    fake = FakeCudart()
    copies = []
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t: copies.append(t.data_ptr()) or t.clone())
    errors = []
    monkeypatch.setattr(sys, "unraisablehook", errors.append)

    pool = HostBatchPool(depth=2)
    a, b, c = (pool.collate(_items(BS, s)) for s in range(3))
    assert (a.pooled, b.pooled, c.pooled) == (True, True, False)

    def pins_in_place(batch):
        host, source = batch.pin()
        return source == "staging" and all(
            t.data_ptr() == batch[k].ctypes.data for k, t in host.items())

    assert pins_in_place(a) and pins_in_place(b)  # the buffers themselves
    assert pool.registered == 2 and fake.registers == 6 and len(fake.live) == 6
    host, source = c.pin()
    assert source == "pin_memory" and len(copies) == 3
    assert all(t.data_ptr() != c[k].ctypes.data for k, t in host.items())
    assert fake.registers == 6
    a.pin()  # the same lease again: nothing new
    a.release()
    d = pool.collate(_items(BS, 3))  # reuses a's set, registered already
    assert d["image"].ctypes.data == a["image"].ctypes.data
    assert pins_in_place(d) and pool.registered == 2 and fake.registers == 6
    # a detached set stays registered while the result that aliases it lives
    alias = {k: torch.from_numpy(v) for k, v in b.items()}
    b.release_after(alias)
    assert pool.stats()["detached"] == 1
    del b
    gc.collect()
    assert len(fake.live) == 6
    del alias
    gc.collect()
    assert len(fake.live) == 3  # b's three buffers were freed, unregistered first
    c.release()  # an ephemeral set: freed unregistered
    d.release()
    del a, c, d, host, pool
    gc.collect()
    assert fake.live == {} and errors == []


def _u8_dataset():
    store = SyntheticImageStore(N_ITEMS, seed=0, avg_kb=4)
    sim = SimulatedS3Store(store, latency_mean_s=0.002, bandwidth_per_conn=1e9,
                           max_connections=64)
    return ImageDataset(sim, N_ITEMS, out_size=24, epilogue="device")


def _cfg(staging, executor="thread"):
    return LoaderConfig(
        batch_size=BS, num_workers=2, prefetch_factor=2, num_fetch_workers=8, seed=11,
        timeout_s=60,
        pipeline=PipelineConfig(enabled=True, cpu_workers=2, cpu_executor=executor,
                                staging_buffers=staging))


def _legacy():
    return make_loader(LoaderConfig(batch_size=BS, num_workers=2, prefetch_factor=2,
                                    num_fetch_workers=8, seed=11), _u8_dataset())


def test_ring_applies_ingest_and_releases_staged_batches():
    """Twin of the reference's shm-transport ring test, over the pipe
    transport: process CPU stage, staging, ingest epilogue after the put."""
    dl = make_loader(_cfg(2, executor="process"), _u8_dataset())
    try:
        ring = DevicePrefetchRing(iter(dl), depth=2, ingest_fn=make_ingest_fn(), device="cpu")
        dl.note_device_ring(ring)  # as the trainer does: the ring is the last stage
        assert dl.stage_stats()["device_prefetch_depth"] == 2
        batches = list(ring)
        ring.close()
    finally:
        dl.close()
    assert len(batches) == N_ITEMS // BS
    for b in batches:
        assert b["image"].dtype == torch.float32  # normalized after the put
        assert b["image"].shape == (BS, 3, 24, 24)
    st = dl.stage_stats()["staging"]
    # every staged lease came back through release_after: on the CPU each
    # one aliased its buffers, so each was detached
    assert st["leases"] >= len(batches)
    assert st["detached"] == st["leases"]
    # the same images as the legacy loader's stream through the same epilogue
    want = list(DevicePrefetchRing(iter(_legacy()), ingest_fn=make_ingest_fn(), device="cpu"))
    for b, w in zip(batches, want, strict=True):
        assert torch.equal(b["image"], w["image"]) and torch.equal(b["label"], w["label"])


def test_cpu_consumer_pins_nothing_with_a_card_present(monkeypatch):
    """Pinning follows the consumer: with ``torch.cuda.is_available()``
    reporting a card, a CPU ring still registers nothing, pins nothing and
    starts no CUDA context; every lease is detached (its result aliases
    the buffers) and the stream is the legacy one."""
    def refuse(*args, **kw):
        raise AssertionError("a CPU consumer reached the CUDA runtime")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "cudart", refuse)
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    dl = make_loader(_cfg(2), _u8_dataset())
    ring = DevicePrefetchRing(iter(dl), depth=2, device="cpu")
    got = list(ring)
    ring.close()
    st = dl.stage_stats()["staging"]
    assert st["leases"] == st["detached"] == len(got) == N_ITEMS // BS
    assert st["registered"] == 0
    assert not torch.cuda.is_initialized()
    for b, w in zip(got, _legacy(), strict=True):
        np.testing.assert_array_equal(b["image"].numpy(), w["image"])
        np.testing.assert_array_equal(b["label"].numpy(), w["label"])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned memory and H2D)")


@pytest.mark.cuda
def test_ring_copies_from_pinned_staging_and_reuses_it_on_the_card():
    """H2D straight from the pool's buffers pinned in place (no
    .pin_memory()), each lease released after its copy landed and reused:
    the ring collates the next batch only after that, so one set,
    registered once, serves the epoch, and the device stream equals the
    legacy loader's."""
    _need_card()
    depth = 2
    dl = make_loader(_cfg(depth), _u8_dataset())
    sources = []

    def watch(it):
        for batch in it:
            yield batch
            # the ring has copied from it by the time it asks for the next;
            # read its set's state only (pinning here would hide a ring
            # that skipped it)
            assert batch.pooled and batch._bufs.pinned
            for k, v in batch.items():
                assert v.ctypes.data == batch._bufs[k].ctypes.data
                assert torch.from_numpy(v).is_pinned()
            sources.append(batch["image"].ctypes.data)

    tracer = Tracer()
    ring = DevicePrefetchRing(watch(iter(dl)), depth=2, device="cuda", tracer=tracer)
    got = [{k: v.cpu() for k, v in b.items()} for b in ring]
    ring.close()
    st = dl.stage_stats()["staging"]
    assert len(got) == N_ITEMS // BS
    assert [s.args["source"] for s in tracer.spans(BATCH_TO_DEVICE)] == ["staging"] * len(got)
    assert st["leases"] == len(got) and st["detached"] == 0
    assert st["allocs"] == st["registered"] == 1 and st["reuses"] == st["leases"] - 1
    assert len(set(sources)) == 1
    for b, w in zip(got, _legacy(), strict=True):
        np.testing.assert_array_equal(b["image"].numpy(), w["image"])
        np.testing.assert_array_equal(b["label"].numpy(), w["label"])


@pytest.mark.cuda
def test_sets_registered_dropped_and_collected_in_a_loop_on_the_card(monkeypatch):
    """cudaHostRegister on the pool's numpy memory, then the memory freed:
    over many rounds of lease, pin, copy, release, overflow, detach and
    collection, no register or unregister fails (a page freed while still
    registered would make a later register of the same page fail), and
    every copy reads the bytes it was given."""
    _need_card()
    errors = []
    monkeypatch.setattr(sys, "unraisablehook", errors.append)
    for rnd in range(40):
        pool = HostBatchPool(depth=1)
        a = pool.collate(_items(BS, rnd, shape=(64, 64, 3)))
        b = pool.collate(_items(BS, rnd + 1000, shape=(64, 64, 3)))  # past depth
        for batch, want in ((a, "staging"), (b, "pin_memory")):
            host, source = batch.pin()
            assert source == want and all(t.is_pinned() for t in host.values())
            dev = {k: t.to("cuda", non_blocking=True) for k, t in host.items()}
            torch.cuda.synchronize()
            for k, v in batch.items():
                np.testing.assert_array_equal(dev[k].cpu().numpy(), v)
            batch.release_after(dev)
        if rnd % 2:
            pool.collate(_items(BS, rnd, shape=(64, 64, 3))).detach()
        assert pool.registered == 1
        del a, b, host, dev, batch, pool
        gc.collect()
    torch.cuda.synchronize()
    assert errors == []


@pytest.mark.cuda
def test_one_buffer_stream_catches_a_release_ahead_of_the_copy_on_the_card():
    """The one-buffer check's witness: each copy is held behind a delay
    kernel on the ring's side stream and the consumer waits before each
    step.  The ring still gives the legacy stream; a ring that releases a
    staged batch before its copy landed, and moves on without waiting,
    lets the next collate overwrite the buffer mid-DMA, and the check sees
    the differing batches."""
    _need_card()
    delay_cycles = 100_000_000  # about 50 ms a copy

    def ring_cls(release_early):
        class Delayed(DevicePrefetchRing):
            def _put_device(self, batch):
                with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                    torch.cuda._sleep(delay_cycles)
                    if not release_early:
                        return super()._put_device(batch)
                    host, _ = batch.pin()
                    dev = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
                    batch.release_after(dev)  # the planted fault
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                return dev, ready
        return Delayed

    def stream(release_early):
        dl = make_loader(_cfg(1), _u8_dataset())
        ring = ring_cls(release_early)(iter(dl), depth=2, device="cuda")
        got = []
        for b in ring:
            time.sleep(0.01)
            got.append({k: v.cpu() for k, v in b.items()})
        ring.close()
        return got, dl.stage_stats()["staging"]

    legacy = list(_legacy())

    def differing(got):
        assert len(got) == len(legacy) == N_ITEMS // BS
        return sum(not (np.array_equal(b["image"].numpy(), w["image"])
                        and np.array_equal(b["label"].numpy(), w["label"]))
                   for b, w in zip(got, legacy, strict=True))

    got, st = stream(release_early=False)
    assert st["allocs"] == 1 and st["detached"] == 0 and st["registered"] == 1
    assert differing(got) == 0
    planted, _ = stream(release_early=True)
    assert differing(planted) > 0
