"""The RWKV-6 WKV wrapper of the port (its plain version on the CPU) against
the JAX reference's Pallas kernel in interpret mode and its ``wkv_ref``
oracle, on the cases and tolerances of ``tests/test_kernels.py``; the
port's chunked scan against the reference's; the wrapper's refusals; the
kernel's order of sums emulated on the CPU; and, on a card, the CUDA kernel
against its plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_wkv.ops import wkv as jax_wkv  # noqa: E402
from repro.kernels.rwkv6_wkv.ref import wkv_ref as jax_wkv_ref  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv_plain  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402


def _inputs(B, S, H, D, seed=0):
    """r, k, v, w, u drawn as ``tests/test_kernels.py::_wkv_inputs`` draws
    them, from numpy: decays exp(-exp(N(0, 0.5) - 0.6)), mostly 0.4-0.75."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    r = n(B, S, H, D) * 0.5
    k = n(B, S, H, D) * 0.5
    v = n(B, S, H, D)
    w = np.exp(-np.exp(n(B, S, H, D) * 0.5 - 0.6)).astype(np.float32)
    u = n(H, D) * 0.1
    return r, k, v, w, u


def _oracle(r, k, v, w, u, s0):
    """The reference's ``wkv_ref`` in its (BH, S, D) layout, back in
    (B, S, H, D)."""
    B, S, H, D = r.shape
    to_bh = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(B * H, S, D)  # noqa: E731
    ub = jnp.broadcast_to(jnp.asarray(u)[None], (B, H, D)).reshape(B * H, D)
    y, sT = jax_wkv_ref(to_bh(r), to_bh(k), to_bh(v), to_bh(w), ub,
                        jnp.asarray(s0).reshape(B * H, D, D))
    return (np.asarray(y).reshape(B, H, S, D).transpose(0, 2, 1, 3),
            np.asarray(sT).reshape(B, H, D, D))


def _port(r, k, v, w, u, s0, **kw):
    y, sT = ops.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)), **kw)
    return y.numpy(), sT.numpy()


@pytest.mark.parametrize("S,chunk,D", [(32, 8, 16), (64, 16, 16), (48, 16, 16), (40, 16, 16),
                                       (40, 16, 64)])
def test_wkv_matches_jax_kernel_and_oracle(S, chunk, D):
    """The reference's four (S, chunk) cases at B=2, H=3, D=16 (S=40 is off
    its chunk grid), and D=64, the rwkv6-7b head size; 2e-4 as there."""
    B, H = 2, 3
    r, k, v, w, u = _inputs(B, S, H, D)
    s0 = np.zeros((B, H, D, D), np.float32)
    got_y, got_s = _port(r, k, v, w, u, s0)
    assert got_y.shape == (B, S, H, D) and got_s.shape == (B, H, D, D)
    want_y, want_s = _oracle(r, k, v, w, u, s0)
    np.testing.assert_allclose(got_y, want_y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_s, want_s, rtol=2e-4, atol=2e-4)
    ky, ks = jax_wkv(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)), chunk=chunk,
                     interpret=True)
    np.testing.assert_allclose(got_y, np.asarray(ky), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_s, np.asarray(ks), rtol=2e-4, atol=2e-4)


def test_wkv_nonzero_initial_state():
    """The reference's nonzero-s0 case (B=1, S=16, H=2, D=8), 5e-4 as there:
    the port loads s0 into the state, the reference folds it in afterwards."""
    B, S, H, D = 1, 16, 2, 8
    r, k, v, w, u = _inputs(B, S, H, D, seed=5)
    s0 = (np.random.default_rng(9).standard_normal((B, H, D, D), dtype=np.float32) * 0.3)
    got_y, got_s = _port(r, k, v, w, u, s0)
    for want_y, want_s in (_oracle(r, k, v, w, u, s0),
                           jax_wkv(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)), chunk=8,
                                   interpret=True)):
        np.testing.assert_allclose(got_y, np.asarray(want_y), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("S,nonzero", [(32, False), (40, False), (40, True)])
def test_chunked_and_seq_scans_match_jax(S, nonzero):
    """The model's plain scans, ``wkv_scan_chunked`` (padded off the chunk
    grid with w = 1) and ``wkv_scan_seq``, against the reference's, 1e-5."""
    B, H, D = 2, 2, 16
    r, k, v, w, u = _inputs(B, S, H, D, seed=3)
    s0 = np.zeros((B, H, D, D), np.float32)
    if nonzero:
        s0 = np.random.default_rng(4).standard_normal(s0.shape, dtype=np.float32) * 0.3
    args = (r, k, v, w, u, s0)
    for port_fn, jax_fn in ((rwkv6.wkv_scan_chunked, jrwkv6.wkv_scan_chunked),
                            (rwkv6.wkv_scan_seq, jrwkv6.wkv_scan_seq)):
        got_y, got_s = port_fn(*(torch.from_numpy(a) for a in args))
        want_y, want_s = jax_fn(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_wkv_is_a_drop_in_for_the_chunked_scan():
    """Twin of tests/test_kernels.py::test_wkv_kernel_agrees_with_model_layer."""
    B, S, H, D = 2, 32, 2, 16
    r, k, v, w, u = _inputs(B, S, H, D, seed=7)
    s0 = np.zeros((B, H, D, D), np.float32)
    ky, ks = _port(r, k, v, w, u, s0)
    my, ms = rwkv6.wkv_scan_chunked(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)),
                                    chunk=16)
    np.testing.assert_allclose(ky, my.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ks, ms.numpy(), rtol=2e-4, atol=2e-4)


def _t(B=1, S=8, H=2, D=8):
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(B, S, H, D))
    return r, k, v, w, u, torch.zeros((B, H, D, D))


def test_refusals():
    r, k, v, w, u, s0 = _t()
    # forward-only, on every device: the reference's kernel has no VJP
    rg = r.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.wkv(rg, k, v, w, u, s0)
    with torch.no_grad():
        assert ops.wkv(rg, k, v, w, u, s0)[0].shape == r.shape
    with pytest.raises(ValueError, match="4-D"):
        ops.wkv(r[0], k[0], v[0], w[0], u, s0)
    with pytest.raises(ValueError, match="must match r"):
        ops.wkv(r, k[:, :4], v, w, u, s0)
    with pytest.raises(ValueError, match=r"u must be \(H, D\)"):
        ops.wkv(r, k, v, w, u[0], s0)
    with pytest.raises(ValueError, match=r"s0 must be \(B, H, D, D\)"):
        ops.wkv(r, k, v, w, u, s0[0])
    with pytest.raises(ValueError, match="float32"):
        ops.wkv(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="head dim 12"):
        ops.wkv(*_t(D=12))
    with pytest.raises(ValueError, match="empty"):
        ops.wkv(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    assert ops.wkv.launches == 0


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it reaches the kernel route."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_without_the_kernel_raises_and_never_falls_back(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a):
        raise AssertionError("the CUDA route fell back to the plain version")

    monkeypatch.setattr(ops, "build", no_nvcc)
    monkeypatch.setattr(ops, "wkv_plain", plain)
    args = [torch.Tensor._make_subclass(_ClaimsCuda, t) for t in _t()]
    assert args[0].device.type == "cuda"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.wkv(*args)
    assert ops.wkv.launches == 0


def _fma(a, b, c):
    """fmaf on fp32 tensors: the product is exact in float64, then one
    rounding to fp32 (a double rounding differs from fmaf's single one at
    most in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _xor_tree(p, lanes, dim):
    """The __shfl_xor_sync tree over ``lanes`` lanes along ``dim``: each
    step adds the lane at distance ``off``; every lane ends with the same
    sum, lane 0's is returned."""
    off = lanes // 2
    while off:
        p = p + p.index_select(dim, torch.arange(lanes) ^ off)
        off //= 2
    return p.select(dim, 0)


def _kernel_order(r, k, v, w, u, s0, G):
    """csrc/wkv.cu's arithmetic in its order, in fp32 on (BH, S, D): lane g
    of a column's group holds rows 4*(q*G + g) + i and sums its part of y_j
    in one fma chain over them (q, then i), the G parts go through the xor
    tree of the reduce-scatter, the bonus is 8 rows a lane (chunks part and
    part + D/8) in a chain of fmas and a tree over D/8 lanes,
    y = fma(bonus, v_j, sum), S = fma(w_i, S, k_i * v_j).  How many columns
    a lane holds (C) does not change the order."""
    BH, S, D = r.shape
    Q, BL = D // G // 4, D // 8
    s = s0.clone()
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        ru = rt.view(BH, 2, BL, 4)
        uk = (u * kt).view(BH, 2, BL, 4)
        p = torch.zeros(BH, BL)
        for m in range(2):
            for c in range(4):
                p = _fma(ru[:, m, :, c], uk[:, m, :, c], p)
        bonus = _xor_tree(p, BL, 1)
        rv, sv = rt.view(BH, Q, G, 4), s.view(BH, Q, G, 4, D)
        y = torch.zeros(BH, G, D)
        for q in range(Q):
            for i in range(4):
                y = _fma(rv[:, q, :, i, None], sv[:, q, :, i], y)
        ys.append(_fma(bonus[:, None], vt, _xor_tree(y, G, 1)))
        s = _fma(wt[:, :, None], s, kt[:, :, None] * vt[:, None, :])
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("D", [64, 128])
def test_kernel_summation_order_stays_inside_the_gate(D):
    """The kernel's order of sums (each lane's part of y_j in one chain, the
    G parts through a shuffle tree, the bonus a pass of its own) emulated in
    fp32 over 4096 tokens, against the plain version in float64: within the
    2e-4 gate with a 4x margin."""
    G, _ = ops.LAYOUT[D]
    B, S, H = 1, 4096, 2
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(B, S, H, D, seed=11))
    s0 = torch.from_numpy(
        np.random.default_rng(12).standard_normal((B, H, D, D), dtype=np.float32) * 0.3)
    bh = lambda a: a.transpose(1, 2).reshape(B * H, S, D)  # noqa: E731
    got_y, got_s = _kernel_order(bh(r), bh(k), bh(v), bh(w), u.repeat(B, 1), s0.reshape(-1, D, D),
                                 G)
    want_y, want_s = wkv_plain(*(a.double() for a in (r, k, v, w, u, s0)))
    tol = 2e-4
    worst = 0.0
    for got, want in ((got_y, bh(want_y)), (got_s, want_s.reshape(-1, D, D))):
        ratio = (got.double() - want).abs() / (tol + tol * want.abs())
        worst = max(worst, ratio.max().item())
    print(f"D={D} G={G}: worst error {worst:.3e} of the 2e-4 gate, margin {1 / worst:.0f}x")
    assert worst <= 0.25


@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_layouts_are_the_ones_the_source_builds(D):
    """The (G, C) the wrapper launches at head dim D is the one kernel
    csrc/wkv.cu instantiates for D (its WKV_CASES), and meets the shape
    rules of its Shape struct: whole float4 chunks of rows and columns a
    lane, a block's threads a multiple of a token row's 16-byte chunks, and
    at least the D/8 lanes the bonus pass gives a token."""
    import re

    text = ops.SOURCE.read_text()
    cases = text[text.index("#define WKV_CASES(X)"):]
    cases = cases[:cases.index("\n\n")]
    built = {tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", cases)}
    assert sorted(built) == sorted((d, *ops.LAYOUT[d]) for d in ops.HEAD_DIMS)
    G, C = ops.LAYOUT[D]
    R, NT, CH = D // G, D // C * G, D // 4
    assert R % 4 == 0 and C % 4 == 0 and G <= 32
    assert NT % CH == 0 and (2048 // D) % (NT // CH) == 0 and NT >= D // 8


_CARD_CASES = [
    # the reference's cases and one per head dim
    (2, 32, 3, 16), (2, 64, 3, 16), (2, 48, 3, 16), (2, 40, 3, 16), (1, 16, 2, 8),
    (2, 100, 2, 32), (2, 70, 3, 64), (1, 33, 2, 128),
    # S off the staged tile of 2048/D tokens at every head dim
    (1, 300, 2, 8), (2, 150, 2, 16), (2, 100, 3, 32), (2, 70, 2, 64), (1, 33, 3, 128),
    # long S, where the accumulated error shows
    (1, 4096, 4, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("nonzero", [False, True], ids=["s0=0", "s0"])
@pytest.mark.parametrize("B,S,H,D", _CARD_CASES)
def test_kernel_matches_plain_version_on_the_card(B, S, H, D, nonzero):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    r, k, v, w, u = (torch.from_numpy(a).cuda() for a in _inputs(B, S, H, D, seed=S + D))
    s0 = torch.zeros((B, H, D, D), device="cuda")
    if nonzero:
        s0 = torch.randn((B, H, D, D), device="cuda") * 0.3
    tol = 5e-4 if nonzero else 2e-4
    want_y, want_s = wkv_plain(r, k, v, w, u, s0)
    before = ops.wkv.launches
    y, sT = ops.wkv(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert ops.wkv.launches == before + 1
    torch.testing.assert_close(y, want_y, rtol=tol, atol=tol)
    torch.testing.assert_close(sT, want_s, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_reads_strided_views_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    x = torch.randn(2, 40, 4, 2, 16, device="cuda")
    r = x[:, :, :, 0]
    w = torch.sigmoid(x[:, :, :, 1])
    u = torch.randn(4, 16, device="cuda") * 0.1
    s0 = torch.zeros(2, 4, 16, 16, device="cuda")
    got = ops.wkv(r, r, r, w, u, s0)
    want = wkv_plain(*(a.cpu() for a in (r, r, r, w, u, s0)))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-4, atol=2e-4)
