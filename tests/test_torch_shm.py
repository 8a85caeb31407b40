"""Twins of ``tests/test_shm_transport.py`` on the port: the shared-memory
transport of the process CPU stage (``repro_torch.core.shm`` and the
pipeline's ``transport="shm"``), pinned staging and the device epilogue.

The same cases and assertions with the imports pointed at ``repro_torch``,
except where the reference's test depends on the machine's scheduling:

* the crash twin arms the crash in every worker before the epoch's first
  task is sent, so a worker surely takes a task after the message and dies
  (the reference arms worker 0 after the first batch, and over 64 items
  that worker may get no further task);
* the copies twin sizes ``slab_slots`` to the whole epoch, so no sample can
  find every slot in flight (``no_slot``) and the fallback rate is 0 on
  every run (the reference's 8 slots a worker give a rate that depends on
  how far decode runs ahead of collate).

The reference's 4-device leg (``test_shm_transport_with_sharded_delivery_4dev``)
has its twin in ``tests/test_torch_delivery.py``.  Beyond the twins: the
port's shm epoch equals the reference's shm epoch byte for byte, a loader
leaves no segment behind after ``close``, the slab knob exists only with
the shm transport and a respawned worker honours its cap, and both packages
pack a sample into the same slot bytes and handle.
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import LoaderConfig as JaxLoaderConfig  # noqa: E402
from repro.config import PipelineConfig as JaxPipelineConfig  # noqa: E402
from repro.core import shm as jax_shm  # noqa: E402
from repro.core.loader import ConcurrentDataLoader as JaxLoader  # noqa: E402
from repro.data.dataset import ImageDataset as JaxImageDataset  # noqa: E402
from repro.data.imagenet_synth import SyntheticImageStore as JaxSyntheticImageStore  # noqa: E402
from repro.data.store import SimulatedS3Store as JaxSimulatedS3Store  # noqa: E402
from repro_torch.config import AutotuneConfig, LoaderConfig, PipelineConfig  # noqa: E402
from repro_torch.core import shm as shm_mod  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.prefetch import DevicePrefetchRing  # noqa: E402
from repro_torch.core.staging import HostBatchPool  # noqa: E402
from repro_torch.core.tracing import BYTES_COPIED, Tracer  # noqa: E402
from repro_torch.data.dataset import ImageDataset, collate  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore  # noqa: E402
from repro_torch.data.store import SimulatedS3Store  # noqa: E402
from repro_torch.kernels.ingest_norm.ops import make_ingest_fn  # noqa: E402

N_ITEMS = 64
BS = 8


def _store(seed=0):
    return SimulatedS3Store(SyntheticImageStore(N_ITEMS, seed=seed, avg_kb=4),
                            latency_mean_s=0.002, bandwidth_per_conn=1e9,
                            max_connections=64)


@pytest.fixture(scope="module")
def dataset():
    return ImageDataset(_store(), N_ITEMS, out_size=24)


def pipe_cfg(transport="pipe", executor="process", staging=0, slot_bytes=1 << 20,
             slots=8, **loader_kw):
    return LoaderConfig(
        batch_size=BS, num_workers=2, prefetch_factor=2, num_fetch_workers=8,
        seed=11, timeout_s=60,
        pipeline=PipelineConfig(
            enabled=True, cpu_workers=2, cpu_executor=executor,
            transport=transport, slab_slot_bytes=slot_bytes, slab_slots=slots,
            staging_buffers=staging,
        ),
        **loader_kw,
    )


def digest(batches):
    return [(float(b["image"].sum()), b["label"].tolist()) for b in batches]


def epoch(dataset, cfg, tracer=None):
    dl = ConcurrentDataLoader(dataset, cfg, tracer=tracer or Tracer())
    try:
        out = list(dl)
        stats = dl.stage_stats()
    finally:
        dl.close()
    return out, stats


def arm_crash_in_every_worker(it, mode="mid_slab_write"):
    """Arm the crash in every worker of the iterator's pool as soon as the
    pump has spawned them, before the epoch's tasks reach them."""
    pool = it.cpu.pool
    deadline = time.monotonic() + 30
    while len(pool.workers) < it.cpu.width:
        assert time.monotonic() < deadline, "the pool never spawned its workers"
        time.sleep(0.001)
    for i in range(len(pool.workers)):
        pool.inject_crash(mode=mode, worker=i)


# --------------------------------------------------------------------------
# unit: slab writer / parent slab
# --------------------------------------------------------------------------


class TestSlab:
    def _pair(self, slot_bytes=4096, slots=4):
        parent = shm_mod.ParentSlab(slot_bytes, slots)
        writer = shm_mod.SlabWriter(*parent.spec())
        return parent, writer

    def test_pack_view_roundtrip(self):
        parent, writer = self._pair()
        try:
            item = {
                "image": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                "label": np.int32(7),
                "nbytes": np.int64(123),
            }
            handle, why = writer.try_pack(item)
            assert why is None
            view = parent.view_item(handle)
            for k in item:
                np.testing.assert_array_equal(np.asarray(view[k]),
                                              np.asarray(item[k]))
            assert handle[2] == shm_mod.item_nbytes(item)
            view.release()
            writer.free_slots(parent.drain_freed())
            assert len(writer.free) == writer.slots
        finally:
            writer.close()
            parent.close()

    def test_stale_generation_free_ignored(self):
        parent, writer = self._pair()
        try:
            handle, _ = writer.try_pack({"x": np.zeros(4)})
            slot, gen = handle[0], handle[1]
            writer.free_slots([(slot, gen)])
            before = len(writer.free)
            # double-free with the now-stale generation: must not re-free
            writer.free_slots([(slot, gen)])
            assert len(writer.free) == before
            assert writer.gens[slot] == gen + 1
        finally:
            writer.close()
            parent.close()

    def test_fallback_reasons(self):
        parent, writer = self._pair(slot_bytes=256, slots=2)
        try:
            _, why = writer.try_pack({"x": np.zeros(1024, dtype=np.uint8)})
            assert why == shm_mod.FALLBACK_OVERSIZE
            _, why = writer.try_pack({"x": np.array([object()], dtype=object)})
            assert why == shm_mod.FALLBACK_RAGGED
            h1, _ = writer.try_pack({"x": np.zeros(8)})
            h2, _ = writer.try_pack({"x": np.zeros(8)})
            assert h1 is not None and h2 is not None
            _, why = writer.try_pack({"x": np.zeros(8)})
            assert why == shm_mod.FALLBACK_NO_SLOT
        finally:
            writer.close()
            parent.close()

    def test_live_cap_skims_high_slots(self):
        parent, writer = self._pair(slots=4)
        try:
            writer.set_cap(1)
            h, _ = writer.try_pack({"x": np.zeros(4)})
            assert h[0] == 0  # only slot 0 usable
            _, why = writer.try_pack({"x": np.zeros(4)})
            assert why == shm_mod.FALLBACK_NO_SLOT
            writer.set_cap(4)  # slots 1-3 are still in the deque, usable again
            h2, _ = writer.try_pack({"x": np.zeros(4)})
            assert h2 is not None
        finally:
            writer.close()
            parent.close()

    def test_reset_reclaims_everything_and_stales_old_handles(self):
        parent, writer = self._pair()
        try:
            handle, _ = writer.try_pack({"x": np.zeros(4)})
            writer.reset()
            assert len(writer.free) == writer.slots
            before = len(writer.free)
            writer.free_slots([(handle[0], handle[1])])  # pre-reset gen
            assert len(writer.free) == before
        finally:
            writer.close()
            parent.close()

    def test_shm_item_release_idempotent(self):
        parent, writer = self._pair()
        try:
            handle, _ = writer.try_pack({"x": np.arange(4)})
            item = parent.view_item(handle)
            item.release()
            item.release()
            assert parent.drain_freed() == [(handle[0], handle[1])]
            assert parent.drain_freed() == []
        finally:
            writer.close()
            parent.close()


def test_slot_bytes_and_handles_equal_the_references():
    """The same sample packed by either package's writer into a slab made
    by the other package gives the same handle and the same slot bytes, and
    each package's parent reads the other's handle back to the sample."""
    rng = np.random.default_rng(5)
    item = {"image": rng.integers(0, 255, (24, 24, 3), dtype=np.uint8),
            "label": np.int32(rng.integers(0, 1000)),
            "nbytes": np.int64(rng.integers(1, 1 << 20)),
            "mask": rng.random(7) < 0.5}
    slabs, handles = [], []
    try:
        for parent_mod, writer_mod in ((shm_mod, jax_shm), (jax_shm, shm_mod)):
            parent = parent_mod.ParentSlab(4096, 2)
            writer = writer_mod.SlabWriter(*parent.spec())
            slabs += [writer, parent]
            handle, why = writer.try_pack(item)
            assert why is None
            handles.append(handle)
            view = parent.view_item(handle)
            for k in item:
                np.testing.assert_array_equal(view[k], item[k])
            view.release()
        assert handles[0] == handles[1]
        size = handles[0][3][-1][3] + item["mask"].nbytes
        assert bytes(slabs[1].shm.buf[:size]) == bytes(slabs[3].shm.buf[:size])
    finally:
        for s in slabs:
            s.close()


# --------------------------------------------------------------------------
# unit: pinned staging pool
# --------------------------------------------------------------------------


class TestStaging:
    def test_collate_matches_default_and_reuses(self):
        pool = HostBatchPool(depth=2)
        items = [{"image": np.full((3, 4), i, np.float32), "label": np.int32(i)}
                 for i in range(4)]
        ref = collate(items)
        got = pool.collate(items)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
            assert got[k].ctypes.data % 4096 == 0  # page-aligned lease
        got.release()
        again = pool.collate(items)
        assert pool.stats()["reuses"] == 1
        again.release()

    def test_release_idempotent_and_pool_bounded(self):
        pool = HostBatchPool(depth=1)
        items = [{"x": np.zeros(8, np.float32)}]
        a = pool.collate(items)
        b = pool.collate(items)  # beyond depth: ephemeral
        a.release()
        a.release()
        b.release()
        s = pool.stats()
        assert s["allocs"] == 1 and s["ephemeral"] == 1


# --------------------------------------------------------------------------
# end-to-end: bit-identity matrix + fallbacks + crash + resume
# --------------------------------------------------------------------------


def test_transport_matrix_bit_identical(dataset):
    ref, _ = epoch(dataset, pipe_cfg(executor="thread"))
    want = digest(ref)
    for transport, staging in (("pipe", 0), ("shm", 0), ("shm", 2)):
        got, stats = epoch(dataset, pipe_cfg(transport=transport,
                                             staging=staging))
        assert digest(got) == want, f"{transport}/staging={staging} diverged"
        t = stats["transport"]
        assert t["kind"] == transport
        if transport == "shm":
            assert t["shm_samples"] > 0
            assert t["slab_slots"] == 8
        if staging:
            assert stats["staging"]["leases"] >= len(got)


def test_shm_halves_transport_copies(dataset):
    """Slots for the whole epoch in every worker's slab: no sample can find
    them all in flight, so every sample takes the slab and the fallback
    rate is 0, whatever the scheduling."""
    tr_pipe, tr_shm = Tracer(), Tracer()
    a, pipe_stats = epoch(dataset, pipe_cfg("pipe"), tracer=tr_pipe)
    b, stats = epoch(dataset, pipe_cfg("shm", slots=N_ITEMS), tracer=tr_shm)
    assert digest(a) == digest(b)
    t = stats["transport"]
    assert t["fallback_rate"] == 0 and t["fallbacks"] == {}
    assert t["shm_samples"] == N_ITEMS and t["pipe_samples"] == 0
    # pipe pays serialize+deserialize (2x) per sample, shm one slab write;
    # both then pay the same collate copy
    assert t["bytes_copied"] * 2 == pipe_stats["transport"]["bytes_copied"]
    assert tr_shm.counter(BYTES_COPIED) < tr_pipe.counter(BYTES_COPIED)


def test_oversized_samples_fall_back_to_pipe(dataset):
    ref, _ = epoch(dataset, pipe_cfg("pipe"))
    # slots far smaller than one decoded image: every sample takes the
    # pickle fallback, stream still bit-identical
    got, stats = epoch(dataset, pipe_cfg("shm", slot_bytes=512, slots=2))
    assert digest(got) == digest(ref)
    t = stats["transport"]
    assert t["shm_samples"] == 0
    assert t["fallbacks"].get("oversize", 0) > 0


def test_crash_mid_slab_write_retries_and_stream_survives(dataset):
    """Every worker is armed before its first task, so each dies on its
    first task after the message with a slot claimed and half-written; the
    parent retires the slabs, respawns and retries the samples."""
    ref, _ = epoch(dataset, pipe_cfg("pipe"))
    dl = ConcurrentDataLoader(dataset, pipe_cfg("shm"))
    try:
        it = iter(dl)
        arm_crash_in_every_worker(it)
        got = [b["label"].tolist() for b in it]
        stats = dl.stage_stats()
    finally:
        dl.close()
    assert got == [d[1] for d in digest(ref)]
    assert stats["cpu_pool"]["crashes"] >= 1
    assert stats["cpu_pool"]["respawns"] >= 1
    assert stats["cpu_pool"]["requeued"] >= 1


def test_resume_cursor_equivalence_across_transports(dataset):
    unbroken, _ = epoch(dataset, pipe_cfg("shm"))
    dl = ConcurrentDataLoader(dataset, pipe_cfg("shm"))
    try:
        it = iter(dl)
        head = [digest([next(it)])[0] for _ in range(2)]
        state = dl.state_dict()
        it.shutdown()
    finally:
        dl.close()
    # resume on the OTHER transport: the cursor is transport-agnostic
    dl2 = ConcurrentDataLoader(dataset, pipe_cfg("pipe"))
    dl2.load_state_dict(state)
    try:
        rest = digest(list(dl2))
    finally:
        dl2.close()
    assert head + rest == digest(unbroken)


def test_transport_validation():
    with pytest.raises(ValueError, match="transport"):
        ConcurrentDataLoader(
            None, LoaderConfig(pipeline=PipelineConfig(enabled=True,
                                                       transport="rdma")))
    with pytest.raises(ValueError, match="slab"):
        ConcurrentDataLoader(
            None, LoaderConfig(pipeline=PipelineConfig(
                enabled=True, transport="shm", slab_slots=0)))
    with pytest.raises(ValueError, match="staging_buffers"):
        ConcurrentDataLoader(
            None, LoaderConfig(pipeline=PipelineConfig(enabled=True,
                                                       staging_buffers=-1)))


# --------------------------------------------------------------------------
# device epilogue: uint8 host batches + the normalize after the put
# --------------------------------------------------------------------------


def test_device_epilogue_matches_host_epilogue(dataset):
    """The reference's tolerance (2e-6) between the u8 stream through the
    ingest epilogue and the host-normalized stream, both over shm."""
    store = dataset.store
    u8 = ImageDataset(store, N_ITEMS, out_size=24, epilogue="device")
    host_batches, _ = epoch(dataset, pipe_cfg("shm"))
    u8_batches, _ = epoch(u8, pipe_cfg("shm"))
    assert u8_batches[0]["image"].dtype == np.uint8
    fn = make_ingest_fn()  # the plain version on CPU tensors; ImageNet mean/std
    for hb, ub in zip(host_batches, u8_batches, strict=True):
        out = fn({k: torch.from_numpy(np.asarray(v)) for k, v in ub.items()})
        np.testing.assert_allclose(out["image"].numpy(), hb["image"],
                                   rtol=2e-6, atol=2e-6)
        np.testing.assert_array_equal(out["label"].numpy(), hb["label"])

    with pytest.raises(ValueError, match="epilogue"):
        ImageDataset(store, N_ITEMS, epilogue="gpu")


def test_ring_applies_ingest_and_releases_staged_batches(dataset):
    u8 = ImageDataset(dataset.store, N_ITEMS, out_size=24, epilogue="device")
    dl = ConcurrentDataLoader(u8, pipe_cfg("shm", staging=2))
    try:
        ring = DevicePrefetchRing(iter(dl), depth=2, ingest_fn=make_ingest_fn(),
                                  device="cpu")
        batches = list(ring)
        ring.close()
        stats = dl.stage_stats()
    finally:
        dl.close()
    assert len(batches) == N_ITEMS // BS
    for b in batches:
        assert b["image"].dtype == torch.float32  # normalized after the put
        assert b["image"].shape == (BS, 3, 24, 24)
    # every staged lease came back: the ring released after each transfer
    st = stats.get("staging")
    assert st is not None and st["leases"] >= len(batches)
    assert stats["transport"]["shm_samples"] > 0


# --------------------------------------------------------------------------
# beyond the twins: across packages, leaks, the slab knob
# --------------------------------------------------------------------------


def test_shm_epoch_equals_the_references():
    """The port's shm epoch and the reference's, over the same u8 dataset
    and config: the same labels and image bytes, batch for batch."""
    def jax_cfg():
        return JaxLoaderConfig(
            batch_size=BS, num_workers=2, prefetch_factor=2, num_fetch_workers=8,
            seed=11, timeout_s=60,
            pipeline=JaxPipelineConfig(enabled=True, cpu_workers=2,
                                       cpu_executor="process", transport="shm",
                                       slab_slots=8))

    port, _ = epoch(ImageDataset(_store(), N_ITEMS, out_size=24, epilogue="device"),
                    pipe_cfg("shm"))
    jds = JaxImageDataset(
        JaxSimulatedS3Store(JaxSyntheticImageStore(N_ITEMS, seed=0, avg_kb=4),
                            latency_mean_s=0.002, bandwidth_per_conn=1e9,
                            max_connections=64),
        N_ITEMS, out_size=24, epilogue="device")
    jdl = JaxLoader(jds, jax_cfg())
    try:
        ref = [{k: np.array(v) for k, v in b.items()} for b in jdl]
        jstats = jdl.stage_stats()
    finally:
        pool = getattr(jdl, "_cpu_pool", None)
        if pool is not None:
            pool.close()
    assert jstats["transport"]["shm_samples"] > 0
    assert len(port) == len(ref) == N_ITEMS // BS
    for p, r in zip(port, ref, strict=True):
        assert p["image"].dtype == r["image"].dtype == np.uint8
        assert np.array_equal(p["image"], r["image"])
        assert np.array_equal(p["label"], r["label"])
        assert np.array_equal(p["nbytes"], r["nbytes"])


def test_no_segment_left_after_close(dataset):
    """Every slab the loader's pool made, a crashed worker's retired one
    included, is gone from /dev/shm once the loader closes."""
    dl = ConcurrentDataLoader(dataset, pipe_cfg("shm"))
    try:
        it = iter(dl)
        arm_crash_in_every_worker(it)
        list(it)
        names = [s.name for s in dl._cpu_pool._slabs]
        crashes = dl.stage_stats()["cpu_pool"]["crashes"]
    finally:
        dl.close()
    assert crashes >= 1 and len(names) >= 3
    if os.path.isdir("/dev/shm"):
        assert [n for n in names if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))] == []
    # attaching by name fails for every one of them
    from multiprocessing import shared_memory

    for n in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=n)


def test_slab_knob_exists_only_with_shm_and_respawns_honour_the_cap(dataset):
    """``slab_slots`` is an autotune knob only while the shm transport is
    live; setting it reaches the pool, and a worker spawned after a crash
    gets the cap (a cap of 1 slot: every sample past the first in flight
    falls back as no_slot, on the respawned workers too)."""
    at = AutotuneConfig(enabled=True, min_slab_slots=1, max_slab_slots=8)
    names = {}
    for transport in ("pipe", "shm"):
        dl = ConcurrentDataLoader(dataset, pipe_cfg(transport, autotune=at))
        try:
            it = iter(dl)
            names[transport] = {k.name for k in dl.autotuner.knobs}
            if transport == "shm":
                knob = next(k for k in dl.autotuner.knobs if k.name == "slab_slots")
                assert (knob.lo, knob.hi, knob.get()) == (1, 8, 8)
                assert knob.set(1) == 1 and dl._cpu_pool.slab_cap == 1
                arm_crash_in_every_worker(it)
                list(it)
                stats = dl.stage_stats()
            else:
                list(it)
        finally:
            dl.close()
    assert "slab_slots" in names["shm"] and "slab_slots" not in names["pipe"]
    assert stats["cpu_pool"]["respawns"] >= 1
    t = stats["transport"]
    assert t["slab_cap"] == 1 and t["slots_peak_per_worker"] <= 1
    assert t["fallbacks"].get("no_slot", 0) > 0
    assert dl._tuned["slab_slots"] == 1
