"""ingest_norm in the port against the JAX reference, and the device epilogue
against the host epilogue through the port's loader and prefetch ring."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ingest_norm.ops import ingest_norm as jax_ingest_norm  # noqa: E402
from repro.kernels.ingest_norm.ref import ingest_norm_ref as jax_ingest_norm_ref  # noqa: E402
from repro_torch.config import LoaderConfig  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.prefetch import DevicePrefetchRing  # noqa: E402
from repro_torch.core.tracing import BATCH_TO_DEVICE, Tracer  # noqa: E402
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import build_synthetic_imagenet  # noqa: E402
from repro_torch.kernels.ingest_norm import ops  # noqa: E402
from repro_torch.kernels.ingest_norm.ref import ingest_norm_ref  # noqa: E402

# tolerances of tests/test_kernels.py
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    C = shape[-1]
    return img, np.linspace(0.4, 0.5, C, dtype=np.float32), np.linspace(0.2, 0.3, C,
                                                                      dtype=np.float32)


@pytest.mark.parametrize("shape", [(2, 24, 24, 3), (1, 32, 16, 3), (4, 8, 8, 4)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_ingest_norm_matches_jax(shape, out_dtype):
    img, mean, std = _inputs(shape)
    got = ops.ingest_norm(torch.from_numpy(img), mean, std, out_dtype)
    assert got.dtype == out_dtype and got.shape == (shape[0], shape[3], shape[1], shape[2])
    got = got.float().numpy()
    jdt = JNP[out_dtype]
    pallas = jax_ingest_norm(jnp.asarray(img), jnp.asarray(mean), jnp.asarray(std),
                             interpret=True).astype(jdt)
    oracle = jax_ingest_norm_ref(jnp.asarray(img), jnp.asarray(mean), jnp.asarray(std), jdt)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=TOL[out_dtype], atol=TOL[out_dtype])


def test_make_ingest_fn_rewrites_only_uint8_nhwc():
    fn = ops.make_ingest_fn()
    img = torch.from_numpy(_inputs((2, 6, 5, 3))[0])
    label = torch.tensor([1, 2], dtype=torch.int32)
    out = fn({"image": img, "label": label})
    assert out["image"].dtype == torch.float32 and out["image"].shape == (2, 3, 6, 5)
    assert out["label"] is label
    from repro_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD

    np.testing.assert_array_equal(
        out["image"].numpy(),
        ingest_norm_ref(img, torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)).numpy())
    # everything else passes through untouched
    f32 = {"image": torch.zeros((2, 3, 6, 5)), "label": label}
    assert fn(f32)["image"] is f32["image"]
    hwc = {"image": img[0]}  # 3-D uint8
    assert fn(hwc)["image"] is hwc["image"]
    host = {"image": img.numpy()}  # not a tensor
    assert fn(host)["image"] is host["image"]
    assert fn({"tokens": label})["tokens"] is label
    assert fn(label) is label  # not a dict
    bf16 = ops.make_ingest_fn(key="x", out_dtype=torch.bfloat16)({"x": img})
    assert bf16["x"].dtype == torch.bfloat16


N_ITEMS, BS = 16, 4


@pytest.fixture(scope="module")
def store():
    return build_synthetic_imagenet(num_items=N_ITEMS, avg_kb=4)


def _epoch(store, epilogue):
    ds = ImageDataset(store, N_ITEMS, out_size=24, epilogue=epilogue)
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2, num_fetch_workers=4)
    return ConcurrentDataLoader(ds, cfg)


def test_device_epilogue_matches_host_epilogue(store):
    host = list(_epoch(store, "host"))
    tracer = Tracer()
    ring = DevicePrefetchRing(iter(_epoch(store, "device")), depth=2, tracer=tracer,
                              ingest_fn=ops.make_ingest_fn(), device="cpu")
    assert ring.set_depth(0) == 1 and ring.set_depth(8) == ring.max_depth == 2  # clamped
    dev = list(ring)
    ring.close()
    assert len(dev) == len(host) == N_ITEMS // BS
    assert len(tracer.spans(BATCH_TO_DEVICE)) == len(dev)
    for hb, db in zip(host, dev):
        assert db["image"].dtype == torch.float32 and db["image"].shape == (BS, 3, 24, 24)
        np.testing.assert_allclose(db["image"].numpy(), hb["image"], rtol=2e-6, atol=2e-6)
        np.testing.assert_array_equal(db["label"].numpy(), hb["label"])
    with pytest.raises(ValueError, match="epilogue"):
        ImageDataset(store, N_ITEMS, epilogue="gpu")


# (shape, path of f32, path of bf16): H*W*C a multiple of 16 and H*W of 4
# (f32) or 8 (bf16) outputs take 16-byte vectors; (2, 30, 224, 3) ends in a
# short run (6720 pixels, runs of 2560)
_PATHS = [
    ((64, 224, 224, 3), "vector", "vector"),
    ((2, 224, 224, 4), "vector", "vector"),
    ((2, 30, 224, 3), "vector", "vector"),
    ((2, 24, 24, 4), "vector", "vector"),
    ((5, 8, 8, 2), "vector", "vector"),
    ((1, 2, 2, 4), "vector", "scalar"),
    ((3, 31, 17, 3), "scalar", "scalar"),
    ((1, 9, 40, 1), "scalar", "scalar"),
    ((1, 6, 6, 1), "scalar", "scalar"),
]


@pytest.mark.parametrize("shape,f32,bf16", _PATHS)
def test_path_for_picks_vector_or_scalar_by_shape(shape, f32, bf16):
    assert ops.path_for(shape, torch.float32) == f32
    assert ops.path_for(shape, torch.bfloat16) == bf16
    # an input that is not 16-byte aligned takes the scalar loop
    assert ops.path_for(shape, torch.float32, data_ptr=4096 + 1) == "scalar"
    assert ops.path_for(shape, torch.bfloat16, data_ptr=4096 + 8) == "scalar"


def test_run_length_is_the_sources():
    """The wrapper's grid check counts blocks of the source's run length."""
    import re

    text = ops.SOURCE.read_text()
    assert int(re.search(r"constexpr int RUN = (\d+);", text).group(1)) == ops.RUN_PIXELS
    assert int(re.search(r"constexpr int MAX_C = (\d+);", text).group(1)) == ops.MAX_C


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,f32,bf16", _PATHS + [((2, 24, 24, 4), "unaligned", "unaligned")])
def test_kernel_matches_plain_version_on_the_card(shape, f32, bf16, out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    img, mean, std = _inputs(shape)
    x = torch.from_numpy(img).cuda()
    path = f32 if out_dtype == torch.float32 else bf16
    if path == "unaligned":  # the same bytes one byte into a buffer
        buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device="cuda")
        x = buf[1:].view(shape).copy_(x)
        path = "scalar"
    assert ops.path_for(x.shape, out_dtype, x.data_ptr()) == path
    before = ops.ingest_norm.launches
    got = ops.ingest_norm(x, mean, std, out_dtype)
    want = ingest_norm_ref(x, torch.from_numpy(mean).cuda(), torch.from_numpy(std).cuda(),
                           out_dtype)
    torch.cuda.synchronize()
    assert ops.ingest_norm.launches == before + 1
    assert got.shape == want.shape and got.dtype == out_dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[out_dtype], (shape, out_dtype, path, err)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ingest_norm(x.transpose(1, 2), mean, std)
