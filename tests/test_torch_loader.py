"""The port's loader stack yields bit-identical batches to the reference's
ConcurrentDataLoader over the same store contents and seed."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.config import LoaderConfig as JaxLoaderConfig  # noqa: E402
from repro.core.loader import ConcurrentDataLoader as JaxLoader  # noqa: E402
from repro.core.tracing import Span as JaxSpan  # noqa: E402
from repro.core.utilization import sample_utilization as jax_sample_utilization  # noqa: E402
from repro.data.dataset import ImageDataset as JaxImageDataset  # noqa: E402
from repro.data.imagenet_synth import build_synthetic_imagenet as jax_build  # noqa: E402
from repro.data.store import SimulatedS3Store as JaxS3  # noqa: E402
from repro_torch.config import LoaderConfig, StoreConfig  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.tracing import GET_BATCH, Span, Tracer, union_duration  # noqa: E402
from repro_torch.core.utilization import sample_utilization  # noqa: E402
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import build_synthetic_imagenet  # noqa: E402
from repro_torch.data.store import build_store  # noqa: E402

N_ITEMS, BS, SIZE = 24, 4, 16
STORE = dict(latency_mean_s=0.002, bandwidth_per_conn=1e9)


@pytest.fixture(scope="module")
def bases():
    port, ref = build_synthetic_imagenet(num_items=N_ITEMS, avg_kb=4), jax_build(
        num_items=N_ITEMS, avg_kb=4)
    assert port.list_keys() == ref.list_keys()
    assert all(port.get(k) == ref.get(k) for k in ref.list_keys())
    return port, ref


def _loaders(bases, impl, epilogue, **kw):
    port_base, ref_base = bases
    cfg = dict(impl=impl, batch_size=BS, num_workers=2, prefetch_factor=2,
               num_fetch_workers=4, seed=11, **kw)
    tracer = Tracer()
    port = ConcurrentDataLoader(
        ImageDataset(build_store(StoreConfig(kind="s3sim", **STORE), base=port_base),
                     N_ITEMS, out_size=SIZE, epilogue=epilogue),
        LoaderConfig(**cfg), tracer=tracer)
    ref = JaxLoader(JaxImageDataset(JaxS3(ref_base, **STORE), N_ITEMS, out_size=SIZE,
                                    epilogue=epilogue), JaxLoaderConfig(**cfg))
    return port, ref, tracer


def _assert_same(port_batches, ref_batches):
    assert len(port_batches) == len(ref_batches) == N_ITEMS // BS
    for pb, rb in zip(port_batches, ref_batches):
        assert sorted(pb) == sorted(rb) == ["image", "label", "nbytes"]
        for k in rb:
            assert pb[k].dtype == rb[k].dtype and pb[k].shape == rb[k].shape, k
            np.testing.assert_array_equal(pb[k], rb[k], err_msg=k)


@pytest.mark.parametrize("epilogue", ["host", "device"])
@pytest.mark.parametrize("impl", ["vanilla", "threaded", "asyncio"])
def test_bit_identical_to_reference(bases, impl, epilogue):
    port, ref, tracer = _loaders(bases, impl, epilogue)
    got, want = list(port), list(ref)
    _assert_same(got, want)
    assert len(tracer.spans(GET_BATCH)) == len(got)
    # second epoch: new permutation and new augmentation draws, still identical
    port.set_epoch(1)
    ref.set_epoch(1)
    _assert_same(list(port), list(ref))


def test_batch_pool_eager_start_and_resume_match(bases):
    port, ref, _ = _loaders(bases, "threaded", "device", batch_pool=12, lazy_init=False)
    want = list(ref)
    _assert_same(list(port), want)
    # resume mid-epoch from a consumer cursor: the rest of the stream replays
    port.load_state_dict({"epoch": 0, "next_batch": 2})
    rest = list(port)
    assert port.state_dict() == {"epoch": 0, "next_batch": N_ITEMS // BS}
    for pb, rb in zip(rest, want[2:]):
        np.testing.assert_array_equal(pb["image"], rb["image"])
    assert len(rest) == len(want) - 2


def test_utilization_matches_reference():
    rng = np.random.default_rng(0)
    t0s = np.sort(rng.uniform(0, 3, 40))
    spans = [(float(a), float(a + d)) for a, d in zip(t0s, rng.uniform(0.01, 0.2, 40))]
    got = sample_utilization([Span("run_training_batch", a, b, 0) for a, b in spans], 0.0, 3.2)
    want = jax_sample_utilization([JaxSpan("run_training_batch", a, b, 0) for a, b in spans],
                                  0.0, 3.2)
    assert got.__dict__ == pytest.approx(want.__dict__)
    assert union_duration([Span("x", 0, 2, 0), Span("x", 1, 3, 0), Span("x", 5, 6, 0)]) == 4


@pytest.mark.parametrize("impl", ["threaded", "asyncio"])
def test_token_batches_bit_identical_to_reference(impl):
    """The LM path: packed token sequences built from the same seed behind
    simulated S3, through both loaders, give the same int32 batches."""
    from repro.data.dataset import TokenDataset as JaxTokenDataset
    from repro.data.dataset import build_token_store as jax_build_tokens
    from repro.data.store import InMemoryStore as JaxInMemoryStore
    from repro_torch.data.dataset import TokenDataset, build_token_store
    from repro_torch.data.store import InMemoryStore

    n, seq, vocab = 12, 24, 97
    port_base, ref_base = InMemoryStore(), JaxInMemoryStore()
    build_token_store(port_base, n, seq, vocab, seed=5)
    jax_build_tokens(ref_base, n, seq, vocab, seed=5)
    assert port_base.list_keys() == ref_base.list_keys()
    assert all(port_base.get(k) == ref_base.get(k) for k in ref_base.list_keys())
    cfg = dict(impl=impl, batch_size=4, num_workers=2, prefetch_factor=2,
               num_fetch_workers=4, seed=3)
    port = ConcurrentDataLoader(
        TokenDataset(build_store(StoreConfig(kind="s3sim", **STORE), base=port_base), n, seq),
        LoaderConfig(**cfg))
    ref = JaxLoader(JaxTokenDataset(JaxS3(ref_base, **STORE), n, seq), JaxLoaderConfig(**cfg))
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == n // 4
        for pb, rb in zip(got, want):
            assert sorted(pb) == sorted(rb) == ["nbytes", "targets", "tokens"]
            for k in rb:
                assert pb[k].dtype == rb[k].dtype and pb[k].shape == rb[k].shape, k
                np.testing.assert_array_equal(pb[k], rb[k], err_msg=k)
            assert pb["tokens"].dtype == np.int32 and pb["tokens"].shape == (4, seq)
            np.testing.assert_array_equal(pb["tokens"][:, 1:], pb["targets"][:, :-1])
