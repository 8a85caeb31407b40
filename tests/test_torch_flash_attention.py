"""flash_attention in the port (its plain version on the CPU) against the JAX
reference's Pallas kernel in interpret mode, on the shapes and tolerances of
``tests/test_kernels.py``; the wrapper's refusals, routing and tensor maps;
the tensor-core kernel's tiling emulated on the CPU; and, on a card, both
CUDA kernels against their plain version."""
import itertools
import math

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


@pytest.mark.parametrize("S,Hq,Hkv", [(64, 3, 3), (96, 3, 3), (64, 8, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_192_matches_jax_kernel(S, Hq, Hkv, causal, dtype):
    """nemotron-4-340b's head dim, which the reference's kernel tiles as
    (block, 192) and the port once refused."""
    got, want = _both(*_inputs(2, Hq, Hkv, S, S, 192), dtype, causal, block_q=32, block_k=32)
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


def test_route_is_fixed_by_dtype_and_head_dim():
    assert [ops.route(torch.bfloat16, D) for D in ops.HEAD_DIMS] == [
        "cuda_core", "cuda_core", "tensor_core", "tensor_core", "tensor_core"]
    assert {ops.route(torch.float32, D) for D in ops.HEAD_DIMS} == {"cuda_core"}


def test_tensor_maps_read_the_models_views_in_place():
    """The model hands the kernel (B,S,H,D) projections as (B,H,S,D) views:
    they go to the kernel as they are, the map's outer dimensions ordered by
    stride (heads, rows, batch), and a dimension of size 1 last."""
    x = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    assert ops._kernel_ready(view) is view
    # sizes (D, heads, rows, batch), byte strides, places of rows, heads, batch
    assert ops._tensor_map(view) == [128, 4, 64, 2, 256, 1024, 65536, 1, 0, 2]
    one = torch.zeros((1, 4, 64, 128), dtype=torch.bfloat16)
    assert ops._tensor_map(one) == [128, 64, 4, 1, 256, 16384, 65536, 0, 1, 2]
    odd = torch.zeros((2, 4, 64, 130), dtype=torch.bfloat16)[..., :128]  # rows 260 B apart
    assert ops._kernel_ready(odd) is not odd and ops._kernel_ready(odd).is_contiguous()
    expanded = torch.zeros((2, 1, 64, 128), dtype=torch.bfloat16).expand(2, 4, 64, 128)
    assert ops._kernel_ready(expanded).stride(1) > 0  # a tensor map cannot step by 0


def _tiles_emulated(q, k, v, split, bk=128):
    """The tensor-core kernel's arithmetic on the CPU, causal, S == T: an
    online softmax over bk-key tiles with P rounded to bf16 for P V, as one
    part (hi) or as hi plus the bf16 of what hi lost (lo)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    S, D = q.shape[-2:]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1 / math.sqrt(D))
    s.masked_fill_(torch.arange(S)[None, :] > torch.arange(S)[:, None], -1e30)
    m = torch.full(s.shape[:-1], -1e30)
    l, acc = torch.zeros(s.shape[:-1]), torch.zeros(qf.shape)
    for k0 in range(0, S, bk):
        tile = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, tile.amax(-1))
        alpha, p = torch.exp(m - m_new), torch.exp(tile - m_new[..., None])
        hi = p.bfloat16().float()
        pv = torch.matmul(hi, vf[..., k0:k0 + bk, :])
        if split:
            pv += torch.matmul((p - hi).bfloat16().float(), vf[..., k0:k0 + bk, :])
        l, acc, m = l * alpha + p.sum(-1), acc * alpha[..., None] + pv, m_new
    return (acc / l.clamp_min(1e-20)[..., None]).bfloat16()


def test_split_p_keeps_bf16_rows_well_inside_the_gate():
    """Why the tensor-core kernel carries P in two bf16 parts: rounded once,
    P moves output rows by about 2.3e-3 of their norm on average and 3.7e-3
    at the largest here, close to chip_smoke's 5e-3 row gate (the maximum
    grows with the number of rows); split, only the output's own bf16
    rounding is left (about 2e-5 on average, 1.3e-3 at the largest)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 4, 4, 1024, 1024, 128,
                                                                 scaled=False))
    want = attention_ref(q, k, v, causal=True).float()
    rel = {}
    for split in (False, True):
        d = _tiles_emulated(q, k, v, split).float() - want
        rel[split] = d.norm(dim=-1) / want.norm(dim=-1)
    assert rel[False].mean() > 1.5e-3 and rel[False].max() > 3e-3
    assert rel[True].mean() < 1e-4 and rel[True].max() < 2e-3


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
             (1, 4, 1, 200, 200, 128), (1, 2, 2, 37, 100, 64), (1, 2, 2, 50, 256, 32),
             (2, 8, 2, 96, 96, 192), (1, 2, 2, 37, 100, 192), (1, 2, 2, 50, 256, 192)]
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


@pytest.mark.cuda
def test_tensor_core_route_matches_plain_version_on_the_card():
    """bf16 at D = 128 through the wgmma kernel: a scaled-down path shape, a
    ragged length off the 128 tile, causal S < T (q_offset > 0), non-causal,
    and the model's strided views read in place (no copy in the trace)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    bf = torch.bfloat16
    cases = [((1, 8, 1024, 128), (1, 2, 1024, 128), True),
             ((1, 8, 1000, 128), (1, 2, 1000, 128), True),
             ((1, 4, 37, 128), (1, 2, 100, 128), True),
             ((1, 4, 200, 128), (1, 2, 256, 128), False)]
    for seed, (qshape, kvshape, causal) in enumerate(cases):
        rng = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(bf).cuda()
                   for s in (qshape, kvshape, kvshape))
        assert ops.route(q.dtype, q.shape[-1]) == "tensor_core"
        before = ops.flash_attention.launches
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert ops.flash_attention.launches == before + 1
        want = attention_ref(q, k, v, causal=causal).float()
        torch.testing.assert_close(got.float(), want, rtol=TOL[bf], atol=TOL[bf])
        assert ((got.float() - want).norm(dim=-1) / want.norm(dim=-1)).max().item() <= 5e-3
    x = torch.randn(2, 300, 8, 128, device="cuda", dtype=bf)  # (B,S,H,D) projections
    kv = torch.randn(2, 300, 2, 128, device="cuda", dtype=bf)
    views = (x.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2))
    ops.flash_attention(*views)  # built before the trace
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = ops.flash_attention(*views)
    copies = [e.key for e in prof.key_averages() if e.key in ("aten::copy_", "aten::clone")]
    assert copies == [], f"strided views were copied: {copies}"
    want = attention_ref(*views).float()
    assert ((got.float() - want).norm(dim=-1) / want.norm(dim=-1)).max().item() <= 5e-3
