"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-large-v3)
against the JAX reference's (``repro.models.encdec``): the config field
for field, ``init_encdec``'s tree with and without ``frontend_proj`` and its
conversion, the sinusoidal tables, ``apply_attention``'s ``kv_source``
branch with and without a cache, ``encode``, the forward loss and one AdamW
step, prefill and lockstep decode, per-slot decode (each row against the
reference's batch-1 ``decode_step`` at that row's position: the reference
serves an int position only), teacher-forced decode against the cacheless
forward, the flash route's launches, and the training launcher's refusal.
Weights are the reference's own, carried across with
``lm_params_from_jax``.

Tolerances, ``tests/test_torch_ssm.py``'s: fp32 within 1e-4 (summation
order only); bf16 tensors within five bf16 spacings at their largest
magnitude (``_tol_bf16``; 0.02 at the 0.63 of that file's outputs, 0.156
at the 4-8 of the encoder's LayerNorm output, where one rounding flip is
0.03125), the bf16 loss within 0.02.  The sinusoidal tables within two
fp32 spacings of the largest position (``_tol_sin``: the frameworks' fp32
``exp`` of the frequency can differ by one ulp, which the position
multiplies: 1.2e-4 at 1500).  Teacher-forced bf16 decode against the
cacheless forward within the reference's own rtol = atol = 2e-2
(``test_decode_matches_forward_gqa``)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.encdec as jE  # noqa: E402
import repro.models.layers as jlayers  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.config import TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import from_jax, lm_params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import encdec, layers  # noqa: E402
from repro_torch.train.steps import lm_train_state, make_eval_step, make_train_step  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCH = "whisper-large-v3"
ROOT = Path(__file__).resolve().parents[1]
TOL_F32 = 1e-4
TOL_BF16 = 0.02
TOL_FORCED = 2e-2
MAX = 24  # the decoder cache's length


def _tol_bf16(want):
    top = float(np.abs(np.asarray(want, np.float32)).max())
    return 5 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _tol_sin(max_pos):
    return 2 * float(np.spacing(np.float32(max(max_pos, 1))))


def _cfgs(dtype="float32", **kw):
    """(port cfg, reference cfg) of the whisper smoke config."""
    return (dataclasses.replace(get_arch(ARCH, smoke=True), dtype=dtype, **kw),
            dataclasses.replace(jax_get_arch(ARCH, smoke=True), dtype=dtype, **kw))


def _models(dtype="float32", seed=0, **kw):
    """(port cfg, port params, reference cfg, reference params as numpy)."""
    cfg, jcfg = _cfgs(dtype, **kw)
    np_params = jax.device_get(jE.init_encdec(jax.random.PRNGKey(seed), jcfg))
    return cfg, lm_params_from_jax(np_params, "cpu", requires_grad=False), jcfg, np_params


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _frames(cfg, B, seed=2):
    return _x((B, cfg.encoder_seq_len, cfg.frontend_dim or cfg.d_model), seed)


def _close(got, want, tol, what="", rtol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=tol, err_msg=what)


def _caches_close(cache, jcache, tol):
    want = flatten(jax.device_get(jcache))
    got = flatten(cache)
    assert list(got) == list(want)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        _close(got[path], want[path], tol, path)


def _jprefill(jcfg):
    return jax.jit(lambda p, b, c: jE.prefill(p, b, jcfg, c))


def _jdecode(jcfg):
    return jax.jit(lambda p, c, t, q: jE.decode_step(p, c, t, q, jcfg))


# ---------------------------------------------------------------------------
# config and init
# ---------------------------------------------------------------------------


def test_whisper_config_matches_the_reference():
    for smoke in (False, True):
        got, want = get_arch(ARCH, smoke=smoke), jax_get_arch(ARCH, smoke=smoke)
        for f in dataclasses.fields(got):
            if f.name != "attention":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert dataclasses.asdict(got.attention) == dataclasses.asdict(want.attention)
    full = get_arch(ARCH)
    assert (full.family, full.num_layers, full.num_encoder_layers, full.encoder_seq_len,
            full.d_model, full.d_ff, full.vocab_size) == \
        ("encdec", 32, 32, 1500, 1280, 5120, 51_866)
    assert (full.mlp, full.norm, full.attention.rope) == ("gelu", "layernorm", False)


@pytest.mark.parametrize("frontend_dim", [0, 48], ids=["no_frontend_proj", "frontend_proj"])
def test_init_encdec_has_the_reference_tree_and_converts(frontend_dim):
    cfg, jcfg = _cfgs(frontend_dim=frontend_dim, num_encoder_layers=3)
    want = flatten(jax.device_get(jE.init_encdec(jax.random.PRNGKey(0), jcfg)))
    got = flatten(encdec.init_encdec(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert list(got) == list(want)
    assert ("frontend_proj/w" in got) == bool(frontend_dim)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        assert str(got[path].dtype).replace("torch.", "") == str(want[path].dtype), path
    assert got["enc_layers/attn/wq"].shape[0] == 3 and got["dec_layers/mlp/w_up"].shape[0] == 2
    conv = flatten(from_jax(want, "cpu"))
    assert list(conv) == list(want)
    for path in want:
        assert np.array_equal(conv[path].numpy(), want[path]), path


def test_init_encdec_draws_on_the_generator():
    """The same seed gives the same weights; LayerNorms start at (1, 0)."""
    cfg, _ = _cfgs()
    a = flatten(encdec.init_encdec(cfg, torch.Generator().manual_seed(3), "cpu"))
    b = flatten(encdec.init_encdec(cfg, torch.Generator().manual_seed(3), "cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["dec_layers/ln3/scale"], torch.ones(2, cfg.d_model))
    assert torch.equal(a["enc_norm/bias"], torch.zeros(cfg.d_model))
    assert not torch.equal(a["enc_layers/attn/wq"][0], a["enc_layers/attn/wq"][1])


# ---------------------------------------------------------------------------
# sinusoidal positions and the kv_source branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,dim", [(16, 64), (1500, 1280), (7, 10)])
def test_sinusoidal_embedding_matches_the_reference(length, dim):
    got = layers.sinusoidal_embedding(length, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, dim)
    _close(got, jlayers.sinusoidal_embedding(length, dim), _tol_sin(length - 1))
    assert torch.equal(got[0, 1::2], torch.ones(dim // 2))  # cos(0) at the odd columns


def test_sinusoidal_embedding_at_matches_the_reference_and_the_table():
    dim = 64
    table = layers.sinusoidal_embedding(300, dim)
    for pos in (0, 5, 299):
        got = encdec.sinusoidal_embedding_at(torch.tensor(pos), dim)
        _close(got, jE.sinusoidal_embedding_at(jnp.int32(pos), dim), _tol_sin(pos), str(pos))
        assert torch.equal(got, table[pos])
    rows = encdec.sinusoidal_embedding_at(torch.tensor([3, 0, 299]), dim)
    assert tuple(rows.shape) == (3, dim)
    assert torch.equal(rows, table[[3, 0, 299]])


@pytest.mark.parametrize("with_cache", [False, True], ids=["no_cache", "cache"])
@pytest.mark.parametrize("arch", [ARCH, "granite-8b"])
def test_apply_attention_kv_source_matches_the_reference(arch, with_cache):
    """Cross-attention through ``kv_source`` (no caller in either package):
    k, v from the source, no RoPE on the pair (granite has RoPE); with a
    cache, the cache's k, v are read and nothing is written."""
    from repro_torch.config import get_arch as garch

    jcfg = dataclasses.replace(jax_get_arch(arch, smoke=True), dtype="float32")
    cfg = dataclasses.replace(garch(arch, smoke=True), dtype="float32")
    a = cfg.attention
    np_p = jax.device_get(jlayers.init_attention(jax.random.PRNGKey(0), jcfg))
    p = from_jax(np_p, "cpu")
    B, S, T = 2, 5, 9
    x, src = _x((B, S, cfg.d_model), 1), _x((B, T, cfg.d_model), 2)
    cache = jcache = None
    if with_cache:
        kv = {k: _x((B, T, a.num_kv_heads, a.head_dim), 3 + i) for i, k in enumerate("kv")}
        jcache = {k: jnp.asarray(v) for k, v in kv.items()}
        cache = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    want, jout = jlayers.apply_attention(np_p, jnp.asarray(x), jcfg, positions=jnp.arange(S),
                                         causal=False, cache=jcache, kv_source=jnp.asarray(src),
                                         cache_pos=jnp.int32(0) if with_cache else None)
    got, out = layers.apply_attention(p, torch.from_numpy(x), cfg,
                                      positions=torch.arange(S), causal=False, cache=cache,
                                      cache_pos=0 if with_cache else None,
                                      kv_source=torch.from_numpy(src))
    _close(got, want, TOL_F32)
    if with_cache:
        assert out is cache
        for k in "kv":
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
    else:
        assert out is None and jout is None


# ---------------------------------------------------------------------------
# encode, the loss and a train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frontend_dim", [0, 48], ids=["no_frontend_proj", "frontend_proj"])
def test_encode_matches_the_reference(dtype, frontend_dim):
    cfg, params, jcfg, np_params = _models(dtype, frontend_dim=frontend_dim)
    frames = _frames(cfg, 2)
    want = jax.jit(lambda p, f: jE.encode(p, f, jcfg))(np_params, jnp.asarray(frames))
    got = encdec.encode(params, torch.from_numpy(frames), cfg)
    assert got.dtype == layers.cdtype(cfg) and tuple(got.shape) == want.shape
    _close(got, want, TOL_F32 if dtype == "float32" else _tol_bf16(want))


def _batch(cfg, B=2, S=12, seed=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "frames": _frames(cfg, B, seed + 1)}


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32), ("bfloat16", TOL_BF16)])
def test_forward_loss_matches_the_reference(dtype, tol):
    cfg, params, jcfg, np_params = _models(dtype)
    batch = _batch(cfg)
    want, want_aux = jax.jit(lambda p, b: jE.forward_train(p, b, jcfg))(
        np_params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, aux = encdec.forward_train(params, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()}, cfg)
    _close(got, want, tol, "loss")
    assert float(aux) == float(want_aux) == 0.0


def test_one_adamw_step_matches_the_reference():
    """fp32, remat on (each layer checkpointed): the step's loss, grad norm
    and every parameter after it."""
    cfg, params, jcfg, np_params = _models("float32")
    assert cfg.remat
    batch = _batch(cfg, seed=6)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
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
        _close(m[k], jm[k], TOL_F32, k)
    want_p = flatten(jax.device_get(jstate["params"]))
    for path, leaf in flatten(state["params"]).items():
        _close(leaf.detach(), want_p[path], TOL_F32, path)


def test_the_flash_route_launches_once_a_decoder_layer(monkeypatch):
    """``attention_impl="pallas"``: ``forward_train`` takes the flash route
    once a decoder layer (the encoder's and the cross-attention's stay
    plain), prefill and decode never; the loss is the plain route's."""
    calls = []
    real = flash_ops.flash_attention

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(flash_ops, "flash_attention", counting)
    cfg, params, _, _ = _models("float32")
    pallas = dataclasses.replace(cfg, attention_impl="pallas")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    got = make_eval_step(pallas)(params, batch)["loss"]
    assert calls == [torch.Size([2, 4, 12, 16])] * cfg.num_layers
    _close(got, make_eval_step(cfg)(params, batch)["loss"], 1e-6)
    calls.clear()
    cache = encdec.init_dec_cache(pallas, 2, 12, "cpu")
    encdec.prefill(params, {"tokens": batch["tokens"], "frames": batch["frames"]}, pallas, cache)
    encdec.decode_step(params, encdec.init_dec_cache(pallas, 2, 13, "cpu"),
                       batch["tokens"][:, :1], np.array([0, 3]), pallas)
    assert calls == []
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(pallas, TrainConfig())


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_init_dec_cache_has_the_reference_tree():
    cfg, jcfg = _cfgs("bfloat16")
    want = flatten(jax.device_get(jE.init_dec_cache(jcfg, 3, MAX)))
    got = flatten(encdec.init_dec_cache(cfg, 3, MAX, "cpu"))
    assert list(got) == list(want)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        assert str(got[path].dtype).replace("torch.", "") == str(want[path].dtype), path
        assert not got[path].any()
    unset = dataclasses.replace(cfg, encoder_seq_len=0)
    assert encdec.init_dec_cache(unset, 1, 4, "cpu")["cross_k"].shape[2] == 1500


def test_prefill_and_lockstep_decode_match_the_reference():
    """fp32: prefill's logits and every cache leaf, then three lockstep
    ``decode_step`` calls at an int position, logits and cache."""
    cfg, params, jcfg, np_params = _models("float32")
    B, S = 2, 10
    toks, frames = _tokens(cfg.vocab_size, B, S), _frames(cfg, B)
    jlogits, jcache = _jprefill(jcfg)(np_params, {"tokens": jnp.asarray(toks),
                                                  "frames": jnp.asarray(frames)},
                                      jE.init_dec_cache(jcfg, B, MAX))
    cache = encdec.init_dec_cache(cfg, B, MAX, "cpu")
    logits, out = encdec.prefill(params, {"tokens": torch.from_numpy(toks),
                                          "frames": torch.from_numpy(frames)}, cfg, cache)
    assert out is cache  # written in place
    _close(logits, jlogits, TOL_F32, "prefill logits")
    _caches_close(cache, jcache, TOL_F32)
    jdecode = _jdecode(jcfg)
    for i in range(3):
        nxt = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
        jlogits, jcache = jdecode(np_params, jcache, jnp.asarray(nxt), jnp.int32(S + i))
        logits, cache = encdec.decode_step(params, cache, torch.from_numpy(nxt), S + i, cfg)
        _close(logits, jlogits, TOL_F32, f"decode {i} logits")
    _caches_close(cache, jcache, TOL_F32)


def test_per_slot_decode_matches_the_reference_batch1_row_by_row():
    """A pooled cache of 3 rows, each prefilled alone (the reference's
    batch-1 prefill, its own prompt length and frames), then two
    ``decode_step`` calls at a (3,) position: each row's logits and cache
    rows against the reference's batch-1 ``decode_step`` at that row's
    scalar position."""
    cfg, params, jcfg, np_params = _models("float32")
    lens = [4, 9, 6]
    jprefill, jdecode = _jprefill(jcfg), _jdecode(jcfg)
    rows = []
    for r, n in enumerate(lens):
        toks, frames = _tokens(cfg.vocab_size, 1, n, seed=10 + r), _frames(cfg, 1, seed=20 + r)
        rows.append(jprefill(np_params, {"tokens": jnp.asarray(toks),
                                         "frames": jnp.asarray(frames)},
                             jE.init_dec_cache(jcfg, 1, MAX)))
    pooled = {k: torch.from_numpy(np.concatenate([np.asarray(c[k]) for _, c in rows], axis=1))
              for k in rows[0][1]}
    nxt = np.array([[int(jnp.argmax(lg[0]))] for lg, _ in rows], np.int32)
    pos = np.array(lens)
    for step in range(2):
        logits, pooled = encdec.decode_step(params, pooled, torch.from_numpy(nxt), pos, cfg)
        for r in range(len(lens)):
            jl, jc = jdecode(np_params, rows[r][1], jnp.asarray(nxt[r:r + 1]), jnp.int32(pos[r]))
            rows[r] = (jl, jc)
            _close(logits[r], jl[0], TOL_F32, f"step {step} row {r}")
            for k in jc:
                _close(pooled[k][:, r], np.asarray(jc[k])[:, 0], TOL_F32, f"{k} row {r}")
        nxt = np.array([[int(jnp.argmax(jl[0]))] for jl, _ in rows], np.int32)
        pos = pos + 1


def test_per_slot_positions_are_checked_on_the_host():
    cfg, params, _, _ = _models("float32")
    cache = encdec.init_dec_cache(cfg, 2, 8, "cpu")
    toks = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside a cache of 8"):
        encdec.decode_step(params, cache, toks, np.array([3, 8]), cfg)
    with pytest.raises(ValueError, match="outside a cache of 8"):
        encdec.decode_step(params, cache, toks, np.array([-1, 2]), cfg)
    with pytest.raises(ValueError, match="max_len"):
        encdec.decode_step(params, cache, toks, 8, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_the_cacheless_forward(dtype):
    """The encoder-decoder twin of ``test_decode_matches_forward_gqa``: a
    one-token prefill, then decode steps fed the sequence, against the
    cacheless forward's logits over the same frames; the port's cacheless
    logits also against the reference's."""
    cfg, params, jcfg, np_params = _models(dtype)
    B, S = 2, 12
    toks, frames = _tokens(cfg.vocab_size, B, S, seed=7), _frames(cfg, B, seed=8)
    tt, tf = torch.from_numpy(toks), torch.from_numpy(frames)
    with torch.no_grad():
        enc = encdec.encode(params, tf, cfg)
        x = encdec._with_positions(params, tt, cfg)
        x = encdec._decoder(params, x, cfg, torch.arange(S), enc=enc)
        full = layers.apply_lm_head(params["lm_head"],
                                    layers.apply_norm(params["final_norm"], x, cfg), cfg)

    def jfull(p, t, f):
        enc = jE.encode(p, f, jcfg)
        ckv = jax.vmap(lambda lp: jE._cross_kv(lp, enc, jcfg))(p["dec_layers"])
        x = jlayers.apply_embedding(p["embed"], t, jcfg)
        x = x + jlayers.sinusoidal_embedding(S, jcfg.d_model).astype(x.dtype)[None]
        x, _ = jE._decoder(p, x, jcfg, jnp.arange(S), ckv)
        return jlayers.apply_lm_head(p["lm_head"], jlayers.apply_norm(p["final_norm"], x, jcfg),
                                     jcfg)

    want = jax.jit(jfull)(np_params, jnp.asarray(toks), jnp.asarray(frames))
    _close(full, want, TOL_F32 if dtype == "float32" else _tol_bf16(want), "cacheless forward")
    logits, cache = encdec.prefill(params, {"tokens": tt[:, :1], "frames": tf}, cfg,
                                   encdec.init_dec_cache(cfg, B, 16, "cpu"))
    steps = [logits]
    for t in range(1, S):
        logits, cache = encdec.decode_step(params, cache, tt[:, t:t + 1], t, cfg)
        steps.append(logits)
    tol = TOL_F32 if dtype == "float32" else TOL_FORCED
    _close(torch.stack(steps, 1), full.float().numpy(), tol, "decode vs cacheless",
           rtol=0.0 if dtype == "float32" else TOL_FORCED)


# ---------------------------------------------------------------------------
# the training launcher (the reference's fault, not copied)
# ---------------------------------------------------------------------------


def test_training_launcher_refuses_encdec_where_the_reference_fails():
    """The reference's launcher dies inside its first step with a bare
    ``KeyError: 'frames'`` (its token dataset carries no frames); the
    port's refuses before building anything, naming the way encdec trains."""
    with pytest.raises(SystemExit, match="carries no frames.*make_train_step"):
        launch_train.run(["--arch", ARCH, "--device", "cpu", "--items", "8",
                          "--batch-size", "2", "--seq-len", "8", "--steps", "1"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro.launch.train", "--arch", ARCH,
                          "--smoke", "--store", "memory", "--steps", "1", "--items", "8",
                          "--seq-len", "8", "--workers", "1", "--fetchers", "1"],
                         capture_output=True, text=True, env=env, timeout=300, check=False)
    assert out.returncode != 0
    assert "KeyError: 'frames'" in out.stderr
