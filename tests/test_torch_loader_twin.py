"""Twins of ``tests/test_loader.py`` on the port alone: the same cases and
assertions with the imports pointed at ``repro_torch`` (worker exceptions,
transient-error retries, hedged stragglers, multi-host partitioning,
resume state, lazy init, dispatch spread, abandoned-iterator collection).
The streams themselves are held to the reference's in
``tests/test_torch_loader.py``."""
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.config import LoaderConfig  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.tracing import GET_BATCH, Tracer  # noqa: E402
from repro_torch.data.dataset import ImageDataset, SyntheticTokenDataset  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore  # noqa: E402
from repro_torch.data.store import SimulatedS3Store  # noqa: E402

N_ITEMS = 96
BS = 16


@pytest.fixture(scope="module")
def dataset():
    store = SyntheticImageStore(N_ITEMS, seed=0, avg_kb=4)
    sim = SimulatedS3Store(store, latency_mean_s=0.004, bandwidth_per_conn=1e9,
                           max_connections=64)
    return ImageDataset(sim, N_ITEMS, out_size=24)


def epoch(impl, dataset, **kw):
    cfg = LoaderConfig(impl=impl, batch_size=BS, num_workers=2, prefetch_factor=2,
                       num_fetch_workers=8, seed=11, **kw)
    dl = ConcurrentDataLoader(dataset, cfg)
    out = list(dl)
    return out


def digest(batches):
    return [
        (float(b["image"].sum()), b["label"].tolist()) for b in batches
    ]


def test_all_impls_bit_identical(dataset):
    ref = digest(epoch("vanilla", dataset))
    assert digest(epoch("threaded", dataset)) == ref
    assert digest(epoch("asyncio", dataset)) == ref
    assert digest(epoch("threaded", dataset, batch_pool=48)) == ref
    assert digest(epoch("threaded", dataset, lazy_init=False)) == ref


def test_batch_shapes_and_count(dataset):
    batches = epoch("threaded", dataset)
    assert len(batches) == N_ITEMS // BS
    for b in batches:
        assert b["image"].shape == (BS, 3, 24, 24)
        assert b["image"].dtype == np.float32
        assert b["label"].shape == (BS,)
        assert not np.isnan(b["image"]).any()


def test_concurrent_faster_than_vanilla():
    store = SyntheticImageStore(64, seed=0, avg_kb=2)
    sim = SimulatedS3Store(store, latency_mean_s=0.02, bandwidth_per_conn=1e9,
                           max_connections=64)
    ds = ImageDataset(sim, 64, out_size=16)

    def measure():
        t0 = time.monotonic(); epoch("vanilla", ds); tv = time.monotonic() - t0
        t0 = time.monotonic(); epoch("threaded", ds); tt = time.monotonic() - t0
        return tv, tt

    tv, tt = measure()
    if not tt < tv / 1.5:
        # wall-clock comparison on a shared CI box: one box stall during
        # either phase flips the verdict, so allow a single re-measure
        tv, tt = measure()
    assert tt < tv / 1.5, (tv, tt)


def test_sharded_loaders_partition_batch(dataset):
    cfgs = dict(batch_size=BS, num_workers=1, seed=3, impl="threaded")
    h0 = list(ConcurrentDataLoader(dataset, LoaderConfig(**cfgs), host_id=0, num_hosts=2))
    h1 = list(ConcurrentDataLoader(dataset, LoaderConfig(**cfgs), host_id=1, num_hosts=2))
    full = list(ConcurrentDataLoader(dataset, LoaderConfig(**cfgs)))
    for b0, b1, fb in zip(h0, h1, full):
        assert b0["image"].shape[0] == BS // 2
        merged = np.concatenate([b0["label"], b1["label"]])
        assert (merged == fb["label"]).all()


def test_lazy_init_constructor_nonblocking(dataset):
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=4, lazy_init=True)
    t0 = time.monotonic()
    dl = ConcurrentDataLoader(dataset, cfg, worker_startup_cost_s=0.15)
    it = iter(dl)
    ctor = time.monotonic() - t0
    assert ctor < 0.1  # returns immediately
    t0 = time.monotonic()
    next(it)
    first = time.monotonic() - t0
    # non-lazy: blocking sequential startup (4 x 0.15 s) before anything loads
    cfg2 = LoaderConfig(impl="threaded", batch_size=BS, num_workers=4, lazy_init=False)
    t0 = time.monotonic()
    dl2 = ConcurrentDataLoader(dataset, cfg2, worker_startup_cost_s=0.15)
    it2 = iter(dl2)
    ctor2 = time.monotonic() - t0
    assert ctor2 >= 0.55
    # time-to-first-batch (ctor+next) must be much better lazily
    next(it2)
    assert ctor + first < ctor2
    it.shutdown(); it2.shutdown()


def test_ordered_delivery(dataset):
    # order must be batch_id order even though workers race
    cfg = LoaderConfig(impl="threaded", batch_size=8, num_workers=4,
                       num_fetch_workers=4, seed=1)
    tr = Tracer()
    dl = ConcurrentDataLoader(dataset, cfg, tracer=tr)
    _ = list(dl)
    bids = [s.args["batch_id"] for s in tr.spans("load_batch")]
    assert sorted(bids) == list(range(N_ITEMS // 8))


def test_get_batch_spans_recorded(dataset):
    tr = Tracer()
    cfg = LoaderConfig(impl="asyncio", batch_size=BS, num_workers=2)
    dl = ConcurrentDataLoader(dataset, cfg, tracer=tr)
    n = len(list(dl))
    assert len(tr.spans(GET_BATCH)) == n
    assert all(s.args.get("nbytes", 0) > 0 for s in tr.spans(GET_BATCH))


def test_multi_epoch_streams_differ(dataset):
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2, seed=5)
    dl = ConcurrentDataLoader(dataset, cfg)
    dl.set_epoch(0)
    e0 = [b["label"].tolist() for b in dl]
    dl.set_epoch(1)
    e1 = [b["label"].tolist() for b in dl]
    assert e0 != e1
    dl.set_epoch(0)
    assert [b["label"].tolist() for b in dl] == e0


def test_loader_resume_state(dataset):
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2, seed=5)
    dl = ConcurrentDataLoader(dataset, cfg)
    it = iter(dl)
    first_two = [next(it)["label"].tolist() for _ in range(2)]
    state = dl.state_dict()
    rest = [b["label"].tolist() for b in it]

    dl2 = ConcurrentDataLoader(dataset, cfg)
    dl2.load_state_dict(state)
    resumed = [b["label"].tolist() for b in dl2]
    # the resumed stream must continue where the checkpoint left off
    assert resumed[: len(rest)] == rest


def test_worker_exception_propagates():
    class Bad(SyntheticTokenDataset):
        def __getitem__(self, i):
            if i == 13:
                raise ValueError("boom")
            return super().__getitem__(i)

    ds = Bad(64, 16, 100)
    cfg = LoaderConfig(impl="threaded", batch_size=8, num_workers=2, shuffle=False,
                       timeout_s=10)
    with pytest.raises(ValueError, match="boom"):
        list(ConcurrentDataLoader(ds, cfg))


def test_transient_failures_are_retried():
    store = SyntheticImageStore(32, seed=0, avg_kb=2)
    sim = SimulatedS3Store(store, latency_mean_s=0.0, failure_rate=0.1, seed=2)
    ds = ImageDataset(sim, 32, out_size=16)
    cfg = LoaderConfig(impl="threaded", batch_size=8, num_workers=2, timeout_s=30)
    batches = list(ConcurrentDataLoader(ds, cfg))
    assert len(batches) == 4  # all batches survive 10% transient failure rate
    assert sim.stats.failures > 0  # ...and failures actually happened


def test_hedged_requests_mitigate_stragglers():
    from repro_torch.data.store import ObjectStore

    class StragglerStore(ObjectStore):
        """~3% of keys stall 50x on their FIRST attempt only (tail latency);
        a duplicate request is fast — exactly the case hedging wins."""

        def __init__(self, base):
            self.base = base
            import threading
            self._lock = threading.Lock()
            self._seen = {}

        def get(self, key):
            idx = int(key.split("/")[-1].split(".")[0])
            with self._lock:
                first = key not in self._seen
                self._seen[key] = True
            time.sleep(0.4 if (first and idx % 31 == 0) else 0.005)
            return self.base.get(key)

        def put(self, key, data):
            self.base.put(key, data)

        def list_keys(self, prefix=""):
            return self.base.list_keys(prefix)

    base = SyntheticImageStore(128, seed=0, avg_kb=2)
    ds = ImageDataset(StragglerStore(base), 128, out_size=16)
    cfg = LoaderConfig(impl="threaded", batch_size=32, num_workers=1,
                       num_fetch_workers=16, hedge_requests=True,
                       hedge_factor=3.0, hedge_min_s=0.05)
    dl = ConcurrentDataLoader(ds, cfg)
    batches = list(dl)
    assert len(batches) == 4
    assert dl.hedge is not None and dl.hedge.hedges_issued > 0
    assert dl.hedge.hedges_won > 0  # the duplicate actually rescued a batch


def test_dispatch_spreads_batches_across_workers():
    """Regression for the worker-0 funnel bug: with lazy init, the round-robin
    must cycle over ALL index queues, not just workers created so far —
    otherwise every batch of the outstanding window lands on worker 0 and
    batch-level parallelism silently serializes (caught by the Fig-10/11
    heatmap benchmark, not by unit tests; see EXPERIMENTS §Repro)."""
    from repro_torch.core.tracing import Tracer
    from repro_torch.core.worker import LOAD_BATCH

    tracer = Tracer()
    ds = SyntheticTokenDataset(128, 16, 256)
    loader = ConcurrentDataLoader(
        ds,
        LoaderConfig(impl="vanilla", batch_size=8, num_workers=4,
                     prefetch_factor=4, lazy_init=True),
        tracer=tracer,
    )
    for _ in loader:
        pass
    workers = {s.args.get("worker") for s in tracer.spans(LOAD_BATCH)}
    assert len(workers) == 4, f"batches funneled to workers {workers}"


def test_legacy_abandoned_iterator_collected_with_autotune(dataset):
    """ROADMAP leak fix: the LEGACY iterator's knob callbacks must hold the
    iterator only weakly — a strong closure on the loader-lived autotuner
    pinned an abandoned ``_LoaderIter`` (and its worker threads) until the
    next epoch's ``bind()``."""
    import gc
    import weakref

    from repro_torch.config import AutotuneConfig

    at = AutotuneConfig(enabled=True)
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2,
                       num_fetch_workers=4, seed=1, autotune=at)
    dl = ConcurrentDataLoader(dataset, cfg)
    it = iter(dl)
    next(it)
    ref = weakref.ref(it)
    workers = list(it.workers)
    del it
    gc.collect()
    assert ref() is None, "knob callbacks still pin the abandoned iterator"
    for w in workers:
        w.join(timeout=5)
        assert not w.thread.is_alive(), "worker threads leaked past abandonment"
    # the dead callbacks are inert: a knob move echoes, nothing crashes
    for k in dl.autotuner.knobs:
        k.set(k.get() or 1)
