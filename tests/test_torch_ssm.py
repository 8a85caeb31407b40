"""The port's Mamba-1 mixer (``repro_torch.models.ssm``) and the hybrid
family (jamba-v0.1-52b) against the JAX reference's (``repro.models.ssm``,
``repro.models.transformer``): ``init_mamba`` and ``init_mamba_cache``'s
trees, ``_ssm_scan`` in both modes, the port's chunked scan against the
reference's whole-sequence ``assoc`` scan, ``apply_mamba`` with and without
a cache and its gradients, the hybrid layer schedule (and the twin of
``tests/test_archs_smoke.py::test_hybrid_layer_schedule``), the forward
loss and one AdamW step of the whole model with unstacked (4 layers, period
4, every sublayer kind) and stacked (16 layers, two blocks of 8) blocks,
and a hybrid prompt never chunked.  Weights are the reference's own,
carried across with ``from_jax`` / ``lm_params_from_jax``.

Tolerances: fp32 scans within 1e-5 (only the order of fp32 products and
sums differs: Hillis–Steele and chunking against ``associative_scan``);
``apply_mamba`` in fp32 within ``tests/test_torch_moe.py``'s 2e-5, its
cache leaves and the model's logits, losses and parameters within
``tests/test_torch_prefill.py``'s 1e-4, gradients within 1e-4; at the
bf16 compute dtype within 0.02, five bf16 spacings at the outputs' largest
magnitude (0.63; measured 0.0059, the frameworks round at other places)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.ssm as jssm  # noqa: E402
import repro.models.transformer as jT  # noqa: E402
from repro.config import SSMConfig as JaxSSMConfig  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.config import SSMConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import from_jax, lm_params_from_jax, to_jax  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.train.steps import lm_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL_SCAN = 1e-5
TOL = 2e-5
TOL_F32 = 1e-4
TOL_BF16 = 0.02
FOUR = dict(num_layers=4, hybrid_attn_period=4)  # one block: 3 Mamba + attention, mlp/moe
SIXTEEN = dict(num_layers=16)  # two stacked blocks of 8
VARIANTS = {"4l": FOUR, "8l": {}, "16l": SIXTEEN}


def _cfgs(dtype="float32", **kw):
    """(port cfg, reference cfg) of the jamba smoke config."""
    return (dataclasses.replace(get_arch(ARCH, smoke=True), dtype=dtype, **kw),
            dataclasses.replace(jax_get_arch(ARCH, smoke=True), dtype=dtype, **kw))


def _mamba_weights(jcfg, seed=0):
    """The reference's init_mamba as numpy, and the port's copy."""
    np_p = jax.device_get(jssm.init_mamba(jax.random.PRNGKey(seed), jcfg))
    return np_p, from_jax(np_p, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=tol, err_msg=what)


def _jtree(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


def test_jamba_config_matches_the_reference():
    """Field for field; the port's ``MoEConfig`` is the reference's without
    ``router_jitter`` (declared there, never read)."""
    assert [f.name for f in dataclasses.fields(SSMConfig)] == \
        [f.name for f in dataclasses.fields(JaxSSMConfig)]
    assert SSMConfig() == SSMConfig(**dataclasses.asdict(JaxSSMConfig()))
    for smoke in (False, True):
        got, want = get_arch(ARCH, smoke=smoke), jax_get_arch(ARCH, smoke=smoke)
        for f in dataclasses.fields(got):
            if f.name not in ("attention", "moe", "ssm"):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
        assert dataclasses.asdict(got.attention) == dataclasses.asdict(want.attention)
        jmoe = dataclasses.asdict(want.moe)
        jmoe.pop("router_jitter")
        assert dataclasses.asdict(got.moe) == jmoe
    full = get_arch(ARCH)
    assert (full.num_layers, full.d_model, full.d_ff, full.vocab_size) == (32, 4096, 14336, 65536)
    assert ssm._dims(full) == jssm._dims(jax_get_arch(ARCH)) == (8192, 16, 4, 256)


@pytest.mark.parametrize("ssm_kw", [None, dict(d_state=4, d_conv=3, expand=1, dt_rank=5)],
                         ids=["smoke", "explicit_dt_rank"])
def test_init_mamba_has_the_reference_tree(ssm_kw):
    cfg, jcfg = _cfgs()
    if ssm_kw is not None:
        cfg = dataclasses.replace(cfg, ssm=SSMConfig(**ssm_kw))
        jcfg = dataclasses.replace(jcfg, ssm=JaxSSMConfig(**ssm_kw))
    want = flatten(jax.device_get(jssm.init_mamba(jax.random.PRNGKey(0), jcfg)))
    got = flatten(ssm.init_mamba(torch.Generator().manual_seed(0), cfg))
    assert list(got) == list(want)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        assert str(got[path].dtype).replace("torch.", "") == str(want[path].dtype), path
    # A_log is the correctly rounded log(1..d_state) on every channel; XLA's
    # CPU log rounds log(7) the other way (1 ulp), so the reference's is
    # held within 1 ulp and the exact value to float64's log rounded
    exact = np.log(np.arange(1, cfg.ssm.d_state + 1, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got["A_log"].numpy(),
                                  np.tile(exact[None], (ssm._dims(cfg)[0], 1)))
    np.testing.assert_array_max_ulp(got["A_log"].numpy(), want["A_log"], maxulp=1)
    for name in ("conv_b", "dt_bias", "D"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def test_init_mamba_cache_has_the_reference_tree():
    cfg, jcfg = _cfgs()
    want = flatten(jax.device_get(jssm.init_mamba_cache(jcfg, 3)))
    got = flatten(ssm.init_mamba_cache(cfg, 3, "cpu"))
    assert list(got) == list(want) == ["conv", "ssm"]
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        assert str(got[path].dtype).replace("torch.", "") == str(want[path].dtype), path
        assert not got[path].any()


@pytest.mark.parametrize("name,kw", list(VARIANTS.items()))
def test_init_cache_has_the_reference_tree(name, kw):
    """The hybrid's cache: k/v for the attention sublayer, conv/ssm for
    each Mamba one, with a leading block axis when blocks are stacked."""
    cfg, jcfg = _cfgs(**kw)
    want = flatten(jax.device_get(jT.init_cache(jcfg, 3, 20)))
    got = flatten(transformer.init_cache(cfg, 3, 20, "cpu"))
    assert list(got) == list(want)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        assert str(got[path].dtype).replace("torch.", "") == str(want[path].dtype), path
        assert not got[path].any()
    stacked = cfg.num_layers // transformer.period(cfg) > 1
    assert tuple(got["sub0/ssm"].shape) == (2,) * stacked + (3, 128, 8)
    assert transformer._cache_len(transformer.init_cache(cfg, 3, 20, "cpu")) == 20


@pytest.mark.parametrize("name,kw", list(VARIANTS.items()))
def test_init_lm_tree_matches_the_reference_and_converts(name, kw):
    """The port's ``init_lm`` has the reference's paths, shapes and dtypes
    (unstacked below two blocks, stacked from two), and
    ``lm_params_from_jax`` carries every Mamba leaf across unchanged."""
    cfg, jcfg = _cfgs(**kw)
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    want = flatten(np_params)
    got = flatten(transformer.init_lm(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert list(got) == list(want)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
    mamba = [p for p in want if "/mamba/" in p]
    assert len(mamba) == 9 * sum(m == "mamba" for m, _ in transformer.layer_kinds(cfg)[
        :transformer.period(cfg)])
    stacked = cfg.num_layers // transformer.period(cfg) > 1
    assert (want["blocks/sub0/mamba/A_log"].ndim == 3) == stacked
    carried = flatten(to_jax(lm_params_from_jax(np_params, "cpu")))
    for path in want:
        np.testing.assert_array_equal(carried[path], want[path], err_msg=path)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 5, 33, 64])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("mode", ["assoc", "seq"])
def test_ssm_scan_matches_the_reference(mode, with_h0, S):
    rng = np.random.default_rng(S)
    B, D, N = 2, 12, 8
    dA = rng.uniform(0.5, 1.0, (B, S, D, N)).astype(np.float32)
    dBx = (0.3 * rng.standard_normal((B, S, D, N))).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32) if with_h0 else None
    jy, jh = jax.jit(jssm._ssm_scan, static_argnums=4)(
        jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C),
        None if h0 is None else jnp.asarray(h0), mode)
    y, h = ssm._ssm_scan(torch.from_numpy(dA), torch.from_numpy(dBx), torch.from_numpy(C),
                         None if h0 is None else torch.from_numpy(h0), mode)
    assert tuple(y.shape) == (B, S, D) and tuple(h.shape) == (B, D, N)
    _close(y, jy, TOL_SCAN, "y")
    _close(h, jh, TOL_SCAN, "h")


def _scan_inputs(S, seed, B=2, D=16, N=8):
    """dt, A, B, C, x as the layer forms them (dt > 0, A = -(1..N))."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.005, 0.3, (B, S, D)).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32)[None], (D, 1))
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32)
    return dt, A, Bm, Cm, x, h0


@pytest.mark.parametrize("S", [ssm.SCAN_CHUNK - 1, ssm.SCAN_CHUNK, ssm.SCAN_CHUNK + 1,
                               3 * ssm.SCAN_CHUNK + 5])
def test_chunked_scan_matches_the_reference_assoc(S):
    """The port's scan over chunks of ``SCAN_CHUNK`` tokens, h carried from
    chunk to chunk and from a given h0, against the reference's ``assoc``
    scan over the whole sequence."""
    dt, A, Bm, Cm, x, h0 = _scan_inputs(S, seed=S)
    @jax.jit
    def reference(dt, A, Bm, Cm, x, h0):  # the reference's apply_mamba, lines 113-119
        dA = jnp.exp(dt[..., None] * A[None, None])
        dBx = dt[..., None] * Bm[:, :, None, :] * x[..., None]
        return jssm._ssm_scan(dA, dBx, Cm, h0, "assoc")

    jy, jh = reference(*(jnp.asarray(a) for a in (dt, A, Bm, Cm, x, h0)))
    t = [torch.from_numpy(a) for a in (dt, A, Bm, Cm, x, h0)]
    y, h = ssm._scan_chunked(*t, mode="assoc")
    _close(y, jy, TOL_SCAN, "y")
    _close(h, jh, TOL_SCAN, "h")


# ---------------------------------------------------------------------------
# apply_mamba
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,S,tol", [("float32", 40, TOL),
                                         ("float32", ssm.SCAN_CHUNK + 7, TOL),
                                         ("bfloat16", 40, TOL_BF16)])
def test_apply_mamba_without_a_cache_matches_the_reference(dtype, S, tol):
    cfg, jcfg = _cfgs(dtype)
    np_p, p = _mamba_weights(jcfg)
    x = _x((2, S, cfg.d_model), 1)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jy, jc = jax.jit(lambda p_, x_: jssm.apply_mamba(p_, x_, jcfg))(
        _jtree(np_p), jnp.asarray(x).astype(jdt))
    y, c = ssm.apply_mamba(p, torch.from_numpy(x).to(tdt), cfg)
    assert jc is None and c is None
    assert y.dtype == tdt and tuple(y.shape) == x.shape
    _close(y, jy.astype(jnp.float32), tol)


@pytest.mark.parametrize("S", [1, 6])
def test_apply_mamba_with_a_cache_matches_the_reference(S):
    """fp32: a prefill of S tokens into ``init_mamba_cache`` (S == 1 takes
    the ``seq`` mode, as a decode step), then 3 single-token decode steps;
    each output and both cache leaves after each call."""
    cfg, jcfg = _cfgs()
    np_p, p = _mamba_weights(jcfg)
    jp = _jtree(np_p)
    B = 2
    jcache = jssm.init_mamba_cache(jcfg, B)
    cache = ssm.init_mamba_cache(cfg, B, "cpu")
    japply = jax.jit(lambda p_, x_, c_: jssm.apply_mamba(p_, x_, jcfg, cache=c_))
    for i, n in enumerate([S, 1, 1, 1]):
        x = _x((B, n, cfg.d_model), 10 + i)
        jy, jcache = japply(jp, jnp.asarray(x), jcache)
        y, cache = ssm.apply_mamba(p, torch.from_numpy(x), cfg, cache=cache)
        _close(y, jy, TOL, f"out {i}")
        for leaf in ("conv", "ssm"):
            assert cache[leaf].dtype == torch.float32
            _close(cache[leaf], jcache[leaf], TOL_F32, f"{leaf} {i}")


@pytest.mark.parametrize("S", [24, ssm.SCAN_CHUNK + 5])
def test_apply_mamba_gradients_match_jax_grad(S):
    """fp32: the gradients of <out, g> with respect to every parameter and
    to x, against ``jax.grad``, within 1e-4, in one chunk and across two."""
    cfg, jcfg = _cfgs()
    np_p, _ = _mamba_weights(jcfg)
    x = _x((2, S, cfg.d_model), 3)
    g = _x((2, S, cfg.d_model), 4)

    def jloss(p, xx):
        return jnp.sum(jssm.apply_mamba(p, xx, jcfg)[0] * jnp.asarray(g))

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_jtree(np_p), jnp.asarray(x))
    p = from_jax(np_p, "cpu", requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = ssm.apply_mamba(p, xt, cfg)
    names = list(flatten(p))
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves(p) + [xt])
    want = flatten(jax.device_get(jgp))
    assert names == list(want)
    for path, got in zip(names, grads):
        np.testing.assert_allclose(got.numpy(), want[path], rtol=1e-4, atol=1e-4, err_msg=path)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------


def test_hybrid_layer_schedule():
    """Twin of ``tests/test_archs_smoke.py::test_hybrid_layer_schedule``."""
    cfg = get_arch(ARCH)
    kinds = transformer.layer_kinds(cfg)
    assert len(kinds) == 32
    assert sum(1 for m, _ in kinds if m == "attn") == 4  # 1:7 interleave
    assert sum(1 for _, f in kinds if f == "moe") == 16  # every other layer
    assert kinds[3][0] == "attn"


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name,kw", list(VARIANTS.items()))
def test_layer_kinds_and_period_match_the_reference(name, kw, smoke):
    got = dataclasses.replace(get_arch(ARCH, smoke=smoke), **kw)
    want = dataclasses.replace(jax_get_arch(ARCH, smoke=smoke), **kw)
    assert transformer.layer_kinds(got) == jT.layer_kinds(want)
    assert transformer.period(got) == jT.period(want) == (4 if kw is FOUR else 8)


@pytest.mark.parametrize("name,kw", [("4l", FOUR), ("16l", SIXTEEN)])
def test_forward_loss_and_a_train_step_match_the_reference(name, kw):
    """fp32: the forward loss and aux loss, then one AdamW step (loss, aux,
    grad norm and every parameter), on one unstacked block of period 4 and
    on two stacked blocks of 8."""
    cfg, jcfg = _cfgs(**kw)
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    params = lm_params_from_jax(np_params, "cpu")
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
             for k in ("tokens", "targets")}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_aux = jax.jit(lambda p, b: jT.forward_train(p, b, jcfg))(np_params, jb)
    with torch.no_grad():
        got, got_aux = transformer.forward_train(params, tb, cfg)
    _close(got, want, 1e-5, "forward loss")
    _close(got_aux, want_aux, 1e-5, "aux loss")
    assert float(got_aux) > 0

    hp = dict(optimizer="adamw", learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jt, tcfg = JaxTrainConfig(**hp), TrainConfig(**hp)
    jstate = {"params": _jtree(np_params), "opt": jax_make_optimizer(jt).init(np_params),
              "step": jnp.zeros((), jnp.int32)}
    state = lm_train_state(params, tcfg)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jt))(jstate, jb)
    state, m = make_train_step(cfg, tcfg)(state, tb)
    for k in ("loss", "aux_loss", "grad_norm"):
        _close(m[k], jm[k], TOL_F32, k)
    want_p = flatten(jax.device_get(jstate["params"]))
    for path, leaf in flatten(state["params"]).items():
        _close(leaf, want_p[path], TOL_F32, path)


def test_a_hybrid_prompt_is_never_chunked(monkeypatch):
    """With ``PREFILL_CHUNK`` at 8 in both packages, a 16-token jamba prompt
    (a multiple above it) still runs in one pass: one ``_apply_blocks`` call
    over all 16 positions, and logits and cache equal to the reference's."""
    monkeypatch.setattr(transformer, "PREFILL_CHUNK", 8)
    monkeypatch.setattr(jT, "PREFILL_CHUNK", 8)
    cfg, jcfg = _cfgs()
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    params = lm_params_from_jax(np_params, "cpu", requires_grad=False)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    passes = []
    real = transformer._apply_blocks

    def spy(params_, x, *args, **kwargs):
        passes.append(x.shape[1])
        return real(params_, x, *args, **kwargs)

    monkeypatch.setattr(transformer, "_apply_blocks", spy)
    logits, cache = transformer.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                                        transformer.init_cache(cfg, 2, 20, "cpu"))
    assert passes == [16]
    jlogits, jcache = jax.jit(lambda p, b, c: jT.prefill(p, b, jcfg, c))(
        np_params, {"tokens": jnp.asarray(toks)}, jT.init_cache(jcfg, 2, 20))
    _close(logits, jlogits, TOL_F32, "logits")
    want = flatten(jax.device_get(jcache))
    for path, leaf in flatten(cache).items():
        _close(leaf, want[path], TOL_F32, path)
