"""RMSNorm in the port (its plain version on the CPU) against the JAX
reference's Pallas kernel in interpret mode, on the shapes, dtypes and
tolerances of ``tests/test_kernels.py``; bf16 activations with an fp32 scale
against ``apply_norm`` (the same function, which no model hands to the
kernel); the wrapper's refusals; and, on a card, the CUDA kernel against
its plain version."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.models.layers import apply_norm as jax_apply_norm  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels.rmsnorm import ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models.layers import apply_norm  # noqa: E402

# tolerances of tests/test_kernels.py
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape[-1:], dtype=np.float32))


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else
                      np.asarray(a, np.float32), np.float32)


@pytest.mark.parametrize("shape", [(8, 128), (4, 16, 256), (1, 384), (130, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_jax_kernel(shape, dtype):
    x, scale = _inputs(shape)
    got = ops.rmsnorm(torch.from_numpy(x).to(dtype), torch.from_numpy(scale).to(dtype))
    assert got.shape == shape and got.dtype == dtype
    jx, js = jnp.asarray(x).astype(JNP[dtype]), jnp.asarray(scale).astype(JNP[dtype])
    want = jax_rmsnorm(jx, js, interpret=True, block_rows=32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(jax_rmsnorm_ref(jx, js)), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_rmsnorm_row_masking():
    """7 rows: the reference pads them to its block of 4; the port's kernel
    masks the rows past n, and its plain version has no blocks."""
    x, _ = _inputs((7, 128))
    scale = np.ones(128, np.float32)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    want = jax_rmsnorm(jnp.asarray(x), jnp.asarray(scale), interpret=True, block_rows=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 24, 64), (3, 100)])
def test_bf16_activations_with_fp32_scale_match_apply_norm(shape):
    """What ``apply_norm`` sees in the LM: bf16 x, an fp32 scale, eps 1e-6;
    the same function as the kernel, in both packages (d = 100 is not a
    multiple of 8, the kernel's bf16 vector width)."""
    x, scale = _inputs(shape, seed=3)
    tx, ts = torch.from_numpy(x).bfloat16(), torch.from_numpy(scale)
    got = ops.rmsnorm(tx, ts)
    assert got.dtype == torch.bfloat16
    cfg = dataclasses.replace(get_arch("granite-8b", smoke=True), d_model=shape[-1])
    jcfg = dataclasses.replace(jax_get_arch("granite-8b", smoke=True), d_model=shape[-1])
    want = jax_apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x).astype(jnp.bfloat16),
                          jcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got, apply_norm({"scale": ts}, tx, cfg), rtol=0, atol=0)


def test_refusals():
    x = torch.from_numpy(_inputs((4, 32))[0])
    scale = torch.ones(32)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.rmsnorm(x.clone().requires_grad_(True), scale)
    with torch.no_grad():
        assert ops.rmsnorm(x.clone().requires_grad_(True), scale).shape == x.shape
    with pytest.raises(ValueError, match=r"scale must be \(32,\)"):
        ops.rmsnorm(x, torch.ones(16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.rmsnorm(x.half(), scale)
    with pytest.raises(ValueError, match="non-empty"):
        ops.rmsnorm(x[:0], scale)
    assert ops.rmsnorm.launches == 0


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it reaches the kernel route."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_without_the_kernel_raises_and_never_falls_back(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a, **k):
        raise AssertionError("the CUDA route fell back to the plain version")

    monkeypatch.setattr(ops, "build", no_nvcc)
    monkeypatch.setattr(ops, "rmsnorm_ref", plain)
    x, scale = (torch.Tensor._make_subclass(_ClaimsCuda, torch.from_numpy(a))
                for a in _inputs((4, 32)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.rmsnorm(x, scale)
    assert ops.rmsnorm.launches == 0


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    shapes = [(8, 128), (4, 16, 256), (1, 384), (130, 128), (7, 128), (9, 100), (3, 4096)]
    for shape in shapes:
        x, scale = (torch.from_numpy(a).cuda() for a in _inputs(shape))
        for xd in (torch.float32, torch.bfloat16):
            for sd in (torch.float32, torch.bfloat16):
                before = ops.rmsnorm.launches
                got = ops.rmsnorm(x.to(xd), scale.to(sd))
                want = rmsnorm_ref(x.to(xd), scale.to(sd))
                torch.cuda.synchronize()
                assert ops.rmsnorm.launches == before + 1
                assert got.dtype == xd and got.shape == x.shape
                torch.testing.assert_close(got.float(), want.float(), rtol=TOL[xd],
                                           atol=TOL[xd])
