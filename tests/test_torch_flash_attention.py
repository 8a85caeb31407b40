"""flash_attention in the port (its plain version on the CPU) against the JAX
reference's Pallas kernel in interpret mode, on the shapes and tolerances of
``tests/test_kernels.py``; the wrapper's refusals; and, on a card, the CUDA
kernel against its plain version."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# tolerances of tests/test_kernels.py
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(B, Hq, Hkv, S, T, D, seed=0, scaled=True):
    """q, k scaled by 1/sqrt(D) as ``tests/test_kernels.py`` draws them, or
    unscaled N(0,1), which gives a peaked softmax."""
    rng = np.random.default_rng(seed)
    div = np.sqrt(D) if scaled else 1.0
    q = rng.standard_normal((B, Hq, S, D), dtype=np.float32) / div
    k = rng.standard_normal((B, Hkv, T, D), dtype=np.float32) / div
    v = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    return q.astype(np.float32), k.astype(np.float32), v


def _both(q, k, v, dtype, causal, **blocks):
    """(port on the CPU, JAX Pallas kernel in interpret mode), as float32."""
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == dtype and got.shape == tq.shape
    jq, jk, jv = (jnp.asarray(a).astype(JNP[dtype]) for a in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=causal, interpret=True, **blocks)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("S,D,bq,bk", [(64, 32, 16, 16), (128, 64, 32, 64), (96, 32, 32, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_matches_jax_kernel(S, D, bq, bk, causal, dtype):
    got, want = _both(*_inputs(2, 3, 3, S, S, D), dtype, causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gqa_matches_jax_kernel(dtype):
    got, want = _both(*_inputs(2, 8, 2, 64, 64, 32), dtype, True, block_q=32, block_k=32)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("S", [50, 200])
def test_flash_odd_seq_matches_jax_kernel(S):
    q, k, v = _inputs(1, 2, 2, S, S, 32)
    got, want = _both(q, k, v, torch.float32, True, block_q=16, block_k=16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    oracle = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_ragged_causal_cross_lengths_follow_the_oracle():
    """S < T with T off the block grid: the port takes q_offset = T - S, as the
    reference's oracle does (its Pallas wrapper takes it on padded lengths)."""
    q, k, v = _inputs(1, 2, 2, 64, 200, 32, seed=1)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    oracle = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_refusals():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 64, 64, 32))
    # forward-only, on every device: the reference's kernel has no VJP
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(qg, k, v)
    with torch.no_grad():
        assert ops.flash_attention(qg, k, v).shape == q.shape
    odd = torch.zeros((1, 2, 64, 48))
    with pytest.raises(ValueError, match="head dim 48"):
        ops.flash_attention(odd, odd, odd)
    long_kv = torch.zeros((1, 2, 200, 32))
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(long_kv, long_kv, long_kv, causal=False)
    with pytest.raises(ValueError, match="S <= T"):
        ops.flash_attention(long_kv, k, v, causal=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ops.flash_attention(torch.zeros((1, 3, 64, 32)), k, v)


def test_plain_version_handles_gqa_as_repeat():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 40, 40, 16, seed=2))
    got = attention_ref(q, k, v, causal=True)
    want = attention_ref(q, k.repeat_interleave(4, 1), v.repeat_interleave(4, 1), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    cases = [(2, 3, 3, 64, 64, 32), (2, 8, 2, 96, 96, 64), (1, 2, 2, 50, 50, 16),
             (1, 4, 1, 200, 200, 128), (1, 2, 2, 37, 100, 64), (1, 2, 2, 50, 256, 32)]
    row_tol = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
    for (B, Hq, Hkv, S, T, D), scaled in itertools.product(cases, (True, False)):
        q, k, v = (torch.from_numpy(a).cuda()
                   for a in _inputs(B, Hq, Hkv, S, T, D, scaled=scaled))
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                if not causal and T > ops.REF_BLOCK_K and T % ops.REF_BLOCK_K:
                    continue
                before = ops.flash_attention.launches
                got = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), causal=causal)
                want = attention_ref(q.to(dt), k.to(dt), v.to(dt), causal=causal)
                torch.cuda.synchronize()
                assert ops.flash_attention.launches == before + 1
                torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])
                # each row against its own size, as chip_smoke gates it
                rel = (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)
                assert rel.max().item() <= row_tol[dt]
    # strided views are read in place: the model's (B,S,H,D) projections
    x = torch.randn(2, 64, 4, 32, device="cuda")
    got = ops.flash_attention(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))
    want = attention_ref(*(x.transpose(1, 2).contiguous(),) * 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
