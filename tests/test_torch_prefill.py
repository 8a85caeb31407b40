"""The port's KV cache, prefill (single pass and chunked) and decode_step
against the JAX reference, for the granite-8b, granite-3-8b,
nemotron-4-340b, minicpm3-4b (MLA), granite-moe-3b-a800m and
qwen2-moe-a2.7b (MoE), rwkv6-7b and jamba-v0.1-52b (hybrid: one block of 8
layers, and two stacked blocks as ``jamba-v0.1-52b-16l``) smoke configs,
from the reference's own initial weights carried across with
``lm_params_from_jax``; every config but granite-8b, rwkv6-7b and the
hybrid (``tests/test_torch_lm.py``, ``tests/test_torch_rwkv6.py``,
``tests/test_torch_ssm.py``) also trains against the reference here.

Tolerances: fp32 logits and cache leaves within 1e-4 of the reference's
(summation order only; measured about 3e-6 on the logits); chunked against
single pass in bf16 within the reference's own 0.05
(``tests/test_prefill_chunked.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
import repro.models.transformer as jT  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.config import TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.train.steps import lm_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

DENSE = ["granite-8b", "granite-3-8b", "nemotron-4-340b"]
MLA_MOE = ["minicpm3-4b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
# the hybrid's smoke config: its one block of 8 (unstacked) and two (stacked)
HYBRID = {"jamba-v0.1-52b": {}, "jamba-v0.1-52b-16l": dict(num_layers=16)}
F32 = dict(dtype="float32")
TOL_F32 = 1e-4
TOL_CHUNKED = 0.05


def _models(arch, **kw):
    """(port cfg, port params, reference cfg, reference params as numpy)."""
    if arch in HYBRID:
        arch, kw = "jamba-v0.1-52b", {**HYBRID[arch], **kw}
    jcfg = dataclasses.replace(jax_get_arch(arch, smoke=True), **kw)
    cfg = dataclasses.replace(get_arch(arch, smoke=True), **kw)
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    return cfg, lm_params_from_jax(np_params, "cpu", requires_grad=False), jcfg, np_params


def _tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=tol, err_msg=what)


def _caches_close(cache, jcache, tol):
    want = flatten(jax.device_get(jcache))
    got = flatten(cache)
    assert list(got) == list(want)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        _close(got[path], want[path], tol, path)


# ---------------------------------------------------------------------------
# the configs trained here
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-8b", "nemotron-4-340b"] + MLA_MOE)
def test_configs_match_the_reference(arch):
    """Field for field; the port's ``MoEConfig`` is the reference's without
    ``router_jitter`` (declared there, never read)."""
    for smoke in (False, True):
        got, want = get_arch(arch, smoke=smoke), jax_get_arch(arch, smoke=smoke)
        for f in dataclasses.fields(got):
            if f.name not in ("attention", "moe"):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        for sub in ("attention", "moe"):
            if getattr(want, sub) is None:
                assert getattr(got, sub) is None, sub
                continue
            names = [f.name for f in dataclasses.fields(getattr(got, sub))]
            assert names == [f.name for f in dataclasses.fields(getattr(want, sub))
                             if f.name != "router_jitter"], sub
            for name in names:
                assert getattr(getattr(got, sub), name) == getattr(getattr(want, sub), name), \
                    (sub, name)
    assert get_arch("granite-3-8b").vocab_size == 49_155  # odd: no multiple of 8
    assert get_arch("nemotron-4-340b").attention.head_dim == 192


@pytest.mark.parametrize("arch", ["granite-3-8b", "nemotron-4-340b"] + MLA_MOE)
def test_forward_loss_and_a_train_step_match_the_reference(arch):
    cfg, params, jcfg, np_params = _models(arch, **F32)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
             for k in ("tokens", "targets")}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_aux = jax.jit(lambda p, b: jT.forward_train(p, b, jcfg))(np_params, jb)
    with torch.no_grad():
        got, got_aux = transformer.forward_train(params, tb, cfg)
    _close(got, want, 1e-5, "forward loss")
    _close(got_aux, want_aux, 1e-5, "aux loss")
    assert (float(got_aux) > 0) == (cfg.moe is not None)

    hp = dict(optimizer="adamw", learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jt, tcfg = JaxTrainConfig(**hp), TrainConfig(**hp)
    jstate = {"params": jax.tree.map(jnp.asarray, np_params),
              "opt": jax_make_optimizer(jt).init(np_params), "step": jnp.zeros((), jnp.int32)}
    for leaf in flatten(params).values():
        leaf.requires_grad_(True)
    state = lm_train_state(params, tcfg)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jt))(jstate, jb)
    state, m = make_train_step(cfg, tcfg)(state, tb)
    for k in ("loss", "aux_loss", "grad_norm"):
        _close(m[k], jm[k], 1e-4, k)
    want_p = flatten(jax.device_get(jstate["params"]))
    for path, leaf in flatten(state["params"]).items():
        _close(leaf.detach(), want_p[path], 1e-4, path)


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,chunk",  # RWKV has no chunked branch; the hybrid never chunks
                         [(a, None) for a in DENSE + MLA_MOE + ["rwkv6-7b"]]
                         + [(a, 8) for a in DENSE + MLA_MOE]
                         + [(a, c) for a in HYBRID for c in (None, 8)])
def test_prefill_and_per_slot_decode_match_the_reference(arch, chunk, monkeypatch):
    """fp32: prefill's logits and every cache leaf (single pass, and chunked
    by 8, each against the reference's own run: an MoE layer routes each
    chunk in its own groups), then one ``decode_step`` with a (B,) position
    (row 1 rewrites an earlier position, as a reused slot does), logits and
    cache."""
    if chunk is not None:
        monkeypatch.setattr(transformer, "PREFILL_CHUNK", chunk)
        monkeypatch.setattr(jT, "PREFILL_CHUNK", chunk)
    cfg, params, jcfg, np_params = _models(arch, **F32)
    B, S, MAX = 2, 16, 24
    toks = _tokens(cfg.vocab_size, B, S)
    # a fresh jit per case: the reference reads PREFILL_CHUNK while tracing
    jlogits, jcache = jax.jit(lambda p, b, c: jT.prefill(p, b, jcfg, c))(
        np_params, {"tokens": jnp.asarray(toks)}, jT.init_cache(jcfg, B, MAX))
    logits, cache = transformer.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                                        transformer.init_cache(cfg, B, MAX, "cpu"))
    _close(logits, jlogits, TOL_F32, "prefill logits")
    _caches_close(cache, jcache, TOL_F32)

    nxt = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
    pos = np.array([S, S - 5], np.int32)
    jlogits, jcache = jax.jit(lambda p, c, t, q: jT.decode_step(p, c, t, q, jcfg))(
        np_params, jcache, jnp.asarray(nxt), jnp.asarray(pos))
    logits, cache = transformer.decode_step(params, cache, torch.from_numpy(nxt), pos, cfg)
    _close(logits, jlogits, TOL_F32, "decode logits")
    _caches_close(cache, jcache, TOL_F32)


@pytest.mark.parametrize("arch", DENSE + ["minicpm3-4b"])
def test_chunked_prefill_matches_single_pass(arch, monkeypatch):
    """Twin of the reference's test of the same name (granite-8b and
    minicpm3-4b there), bf16 as there.  Not for MoE: its groups are per
    chunk, so a chunk's capacity drops differ from a single pass's."""
    cfg = get_arch(arch, smoke=True)
    _, params, _, _ = _models(arch)
    B, S = 2, 32
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, B, S))}
    logits1, c1 = transformer.prefill(params, batch, cfg,
                                      transformer.init_cache(cfg, B, S, "cpu"))
    monkeypatch.setattr(transformer, "PREFILL_CHUNK", 8)
    logits2, c2 = transformer.prefill(params, batch, cfg,
                                      transformer.init_cache(cfg, B, S, "cpu"))
    assert (logits1.float() - logits2.float()).abs().max().item() < TOL_CHUNKED
    for a, b in zip(flatten(c1).values(), flatten(c2).values()):
        assert (a.float() - b.float()).abs().max().item() < TOL_CHUNKED


@pytest.mark.parametrize("arch", DENSE)
def test_chunked_prefill_then_decode_consistent(arch, monkeypatch):
    """Decode after a chunked prefill continues exactly like decode after a
    single-pass prefill (twin of the reference's test, bf16)."""
    cfg = get_arch(arch, smoke=True)
    _, params, _, _ = _models(arch)
    B, S, MAX = 2, 16, 24
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, B, S))}

    def run(chunk):
        monkeypatch.setattr(transformer, "PREFILL_CHUNK", chunk)
        logits, cache = transformer.prefill(params, batch, cfg,
                                            transformer.init_cache(cfg, B, MAX, "cpu"))
        nxt = torch.argmax(logits, -1)[:, None]
        outs = []
        for i in range(4):
            logits, cache = transformer.decode_step(params, cache, nxt, S + i, cfg)
            nxt = torch.argmax(logits, -1)[:, None]
            outs.append(nxt)
        return torch.cat(outs, 1)

    assert torch.equal(run(10_000), run(4))


# ---------------------------------------------------------------------------
# the cache's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers_", [None, 1], ids=["stacked", "one_layer"])
@pytest.mark.parametrize("arch", ["granite-8b", "rwkv6-7b", "minicpm3-4b", "qwen2-moe-a2.7b"])
def test_init_cache_has_the_reference_tree(arch, layers_):
    kw = {} if layers_ is None else {"num_layers": layers_}
    cfg = dataclasses.replace(get_arch(arch, smoke=True), **kw)
    jcfg = dataclasses.replace(jax_get_arch(arch, smoke=True), **kw)
    want = flatten(jax.device_get(jT.init_cache(jcfg, 3, 20)))
    got = flatten(transformer.init_cache(cfg, 3, 20, "cpu"))
    assert list(got) == list(want)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        assert str(got[path].dtype).replace("torch.", "") == str(want[path].dtype), path
        assert not got[path].any()
    stacked_k = [v for p, v in got.items() if p.endswith(("/k", "/c_kv", "/state"))][0]
    assert (stacked_k.shape[0] == cfg.num_layers) == (layers_ is None)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "per_row"])
def test_cache_update_matches_the_reference(vector):
    rng = np.random.default_rng(4)
    B, T, S, H, D = 3, 10, 2, 2, 4
    kc, vc = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(2))
    pos = np.array([0, 5, 8], np.int32) if vector else 3
    jk, jv = jlayers._cache_update({"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                   jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos) if vector else pos)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    gk, gv = layers._cache_update(cache, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(pos) if vector else pos)
    assert gk is cache["k"] and gv is cache["v"]  # written in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


def test_a_write_past_max_len_raises():
    """The reference's ``dynamic_update_slice`` clamps such a write onto
    earlier positions (a fault not copied): the port raises."""
    rng = np.random.default_rng(5)
    cache = {"k": torch.zeros((1, 8, 1, 4)), "v": torch.zeros((1, 8, 1, 4))}
    kv = torch.from_numpy(rng.standard_normal((1, 2, 1, 4)).astype(np.float32))
    jk, _ = jlayers._cache_update({"k": jnp.zeros((1, 8, 1, 4)), "v": jnp.zeros((1, 8, 1, 4))},
                                  jnp.asarray(kv.numpy()), jnp.asarray(kv.numpy()), 7)
    assert np.asarray(jk)[0, 6:].any()  # the reference wrote positions 6, 7, not 7, 8
    with pytest.raises(ValueError, match="max_len"):
        layers._cache_update(cache, kv, kv, 7)
    assert not cache["k"].any()

    cfg = get_arch("granite-8b", smoke=True)
    _, params, _, _ = _models("granite-8b")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 9))
    with pytest.raises(ValueError, match="max_len"):
        transformer.prefill(params, {"tokens": toks}, cfg,
                            transformer.init_cache(cfg, 2, 8, "cpu"))
    cache = transformer.init_cache(cfg, 2, 8, "cpu")
    with pytest.raises(ValueError, match="max_len"):
        transformer.decode_step(params, cache, toks[:, :1], 8, cfg)
    with pytest.raises(ValueError, match="outside a cache of 8"):
        transformer.decode_step(params, cache, toks[:, :1], np.array([3, 8]), cfg)


def test_no_flash_launch_with_a_cache(monkeypatch):
    """With ``attention_impl="pallas"`` and a cache exactly S long (so S ==
    T), prefill and decode still take the plain masked attention: the
    flash route needs ``kv_len is None``.  Without a cache it is taken."""
    calls = []
    real = flash_ops.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(flash_ops, "flash_attention", counting)
    cfg = dataclasses.replace(get_arch("granite-8b", smoke=True), attention_impl="pallas")
    _, params, _, _ = _models("granite-8b")
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg.vocab_size, B, S))
    logits, cache = transformer.prefill(params, {"tokens": toks}, cfg,
                                        transformer.init_cache(cfg, B, S, "cpu"))
    transformer.decode_step(params, transformer.init_cache(cfg, B, S + 1, "cpu"),
                            toks[:, :1], np.array([0, 3]), cfg)
    assert calls == []
    with torch.no_grad():
        transformer.forward_train(params, {"tokens": toks, "targets": toks}, cfg)
    assert len(calls) == cfg.num_layers
