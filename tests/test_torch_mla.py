"""The port's multi-head latent attention (``layers.apply_mla_attention``)
against the JAX reference's, at the minicpm3-4b smoke widths in fp32: with
no cache, in prefill at an int offset and in decode at (B,) per-slot
positions, on both branches (absorbed into the latent space, and expanded
over the cache); the twin of
``tests/test_prefill_chunked.py::test_mla_absorbed_decode_matches_expanded``;
a write past ``max_len``; and ``_cache_len`` on an MLA cache.  Weights are
the reference's own (``init_attention``), carried across with ``from_jax``.
The twin of ``test_chunked_prefill_matches_single_pass[minicpm3-4b]`` is in
``tests/test_torch_prefill.py`` with the other archs.

Tolerances: fp32 outputs and cache leaves within 1e-4 of the reference's
(as ``tests/test_torch_prefill.py``); absorbed against expanded decode
within the reference's own 2e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
import repro.models.transformer as jT  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import from_jax, lm_params_from_jax  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCH = "minicpm3-4b"
TOL_F32 = 1e-4
TOL_ABSORBED = 2e-4


def _cfgs(**kw):
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(get_arch(ARCH, smoke=True), **kw),
            dataclasses.replace(jax_get_arch(ARCH, smoke=True), **kw))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol, err_msg=what)


def _case(name, cfg, rng):
    """(x, positions, cache or None, cache_pos) as numpy for one call."""
    a = cfg.attention
    B, MAX = 3, 20
    cache = {"c_kv": rng.standard_normal((B, MAX, a.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal((B, MAX, a.qk_rope_head_dim)).astype(np.float32)}
    if name == "no_cache":
        S = 12
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32), \
            np.arange(S, dtype=np.int32), None, None
    if name == "prefill":  # 5 positions written at an int offset of 3
        x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
        return x, np.arange(3, 8, dtype=np.int32), cache, 3
    # decode: one token a row at its own position; row 1 rewrites an earlier one
    pos = np.array([9, 2, 14], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    return x, pos[:, None], cache, pos


@pytest.mark.parametrize("name,branch", [("no_cache", "expanded"), ("prefill", "absorbed"),
                                         ("prefill", "expanded"), ("decode", "absorbed"),
                                         ("decode", "expanded")])
def test_apply_mla_attention_matches_the_reference(name, branch, monkeypatch):
    cfg, jcfg = _cfgs()
    if branch == "expanded":
        monkeypatch.setattr(layers, "MLA_ABSORB_MAX_S", 0)
        monkeypatch.setattr(jlayers, "MLA_ABSORB_MAX_S", 0)
    np_p = jax.device_get(jlayers.init_attention(jax.random.PRNGKey(0), jcfg))
    p = from_jax(np_p, "cpu")
    mine = layers.init_attention(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in np_p.items()}
    x, positions, cache, cache_pos = _case(name, cfg, np.random.default_rng(1))
    vector = isinstance(cache_pos, np.ndarray)
    jy, jcache = jlayers.apply_mla_attention(
        np_p, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache),
        cache_pos=jnp.asarray(cache_pos) if vector else cache_pos)
    tcache = None if cache is None else from_jax(cache, "cpu")
    y, got = layers.apply_mla_attention(
        p, torch.from_numpy(x), cfg, positions=torch.from_numpy(positions).long(),
        cache=tcache, cache_pos=torch.from_numpy(cache_pos) if vector else cache_pos)
    _close(y, jy, TOL_F32, "y")
    if cache is None:
        assert got is None
        return
    for key in ("c_kv", "k_rope"):
        assert got[key] is tcache[key]  # written in place
        _close(got[key], jcache[key], TOL_F32, key)


def _prefilled(cfg, jcfg, B=2, S=12, MAX=20):
    """minicpm3 smoke (fp32, the reference's weights) prefilled in the
    port: (port params, port cache, reference params, next tokens, S)."""
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    params = lm_params_from_jax(np_params, "cpu", requires_grad=False)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = transformer.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                                        transformer.init_cache(cfg, B, MAX, "cpu"))
    return params, cache, np_params, torch.argmax(logits, -1)[:, None], S


def test_mla_absorbed_decode_matches_expanded(monkeypatch):
    """Twin of the reference's test: the absorbed-matmul decode equals the
    expanded-cache decode (fp32)."""
    cfg, jcfg = _cfgs()
    params, cache, _, nxt, S = _prefilled(cfg, jcfg)
    l_abs, _ = transformer.decode_step(params, cache, nxt, S, cfg)
    monkeypatch.setattr(layers, "MLA_ABSORB_MAX_S", 0)
    l_exp, _ = transformer.decode_step(params, cache, nxt, S, cfg)
    assert (l_abs - l_exp).abs().max().item() < TOL_ABSORBED


def test_a_write_past_max_len_raises_for_mla():
    """As ``_cache_update``: a prefill or decode past the cache raises, and
    per-slot positions are bounded by the MLA cache's length."""
    cfg, _ = _cfgs()
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32))
    with pytest.raises(ValueError, match="max_len"):
        transformer.prefill(params, {"tokens": toks}, cfg,
                            transformer.init_cache(cfg, 2, 8, "cpu"))
    cache = transformer.init_cache(cfg, 2, 8, "cpu")
    with pytest.raises(ValueError, match="max_len"):
        transformer.decode_step(params, cache, toks[:, :1], 8, cfg)
    with pytest.raises(ValueError, match="outside a cache of 8"):
        transformer.decode_step(params, cache, toks[:, :1], np.array([3, 8]), cfg)
    assert not any(leaf.any() for leaf in flatten(cache).values())


@pytest.mark.parametrize("layers_", [None, 1], ids=["stacked", "one_layer"])
def test_cache_len_reads_an_mla_cache(layers_):
    kw = {} if layers_ is None else {"num_layers": layers_}
    cfg, _ = _cfgs(**kw)
    cache = transformer.init_cache(cfg, 3, 20, "cpu")
    assert set(cache["sub0"]) == {"c_kv", "k_rope"}
    assert transformer._cache_len(cache) == 20
