"""The port's VLM stub (internvl2-26b: a decoder whose first
``num_patch_tokens`` positions take projected precomputed patch
embeddings) against the JAX reference's (``repro.models.transformer``):
the config field for field, ``init_lm``'s tree with ``patch_proj``,
``_embed_inputs``, the forward loss with the patch positions masked out and
one AdamW step, and a VLM prompt never chunked.  Weights are the
reference's own, carried across with ``lm_params_from_jax``.

Tolerances, ``tests/test_torch_ssm.py``'s: fp32 within 1e-4 (summation
order only); the bf16 loss within 0.02."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.transformer as jT  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.config import TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train.steps import lm_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCH = "internvl2-26b"
TOL_F32 = 1e-4
TOL_BF16 = 0.02


def _models(dtype="float32", **kw):
    """(port cfg, port params, reference cfg, reference params as numpy)."""
    jcfg = dataclasses.replace(jax_get_arch(ARCH, smoke=True), dtype=dtype, **kw)
    cfg = dataclasses.replace(get_arch(ARCH, smoke=True), dtype=dtype, **kw)
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    return cfg, lm_params_from_jax(np_params, "cpu", requires_grad=False), jcfg, np_params


def _batch(cfg, B=2, S=24, seed=3, patches=True):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
    if patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=tol, err_msg=what)


def test_internvl_config_matches_the_reference():
    for smoke in (False, True):
        got, want = get_arch(ARCH, smoke=smoke), jax_get_arch(ARCH, smoke=smoke)
        for f in dataclasses.fields(got):
            if f.name != "attention":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert dataclasses.asdict(got.attention) == dataclasses.asdict(want.attention)
    full = get_arch(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.num_patch_tokens,
            full.frontend_dim) == ("decoder", 48, 6144, 1024, 3200)
    assert transformer.layer_kinds(full) == [("attn", "mlp")] * 48


@pytest.mark.parametrize("layers_", [None, 1], ids=["stacked", "one_layer"])
def test_init_lm_has_the_reference_tree_with_patch_proj(layers_):
    kw = {} if layers_ is None else dict(num_layers=layers_)
    cfg = dataclasses.replace(get_arch(ARCH, smoke=True), **kw)
    jcfg = dataclasses.replace(jax_get_arch(ARCH, smoke=True), **kw)
    want = flatten(jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg)))
    got = flatten(transformer.init_lm(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert list(got) == list(want)
    assert tuple(got["patch_proj/w"].shape) == (cfg.frontend_dim, cfg.d_model)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
    plain = dataclasses.replace(cfg, frontend_dim=0)
    assert "patch_proj" not in transformer.init_lm(plain, torch.Generator(), "cpu")


@pytest.mark.parametrize("patches", [True, False], ids=["patch_embeds", "tokens_only"])
def test_embed_inputs_matches_the_reference(patches):
    cfg, params, jcfg, np_params = _models()
    batch = _batch(cfg, patches=patches)
    want = jT._embed_inputs(np_params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    got = transformer._embed_inputs(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    cfg)
    assert tuple(got.shape) == want.shape == (2, 24, cfg.d_model)
    _close(got, want, TOL_F32)
    emb = params["embed"]["w"][torch.from_numpy(batch["tokens"]).long()]
    P = cfg.num_patch_tokens
    assert torch.equal(got[:, P:], emb[:, P:])
    assert torch.equal(got[:, :P], emb[:, :P]) != patches


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32), ("bfloat16", TOL_BF16)])
@pytest.mark.parametrize("S", [24, 6], ids=["longer_than_the_prefix", "inside_the_prefix"])
def test_masked_loss_matches_the_reference(dtype, tol, S):
    """The patch positions' targets are out of the loss; a sequence no
    longer than the prefix has nothing left and a loss of zero, as the
    reference's."""
    cfg, params, jcfg, np_params = _models(dtype)
    batch = _batch(cfg, S=S) if S > cfg.num_patch_tokens else \
        {k: v[:, :S] for k, v in _batch(cfg, patches=False).items()}
    want, _ = jax.jit(lambda p, b: jT.forward_train(p, b, jcfg))(
        np_params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, aux = transformer.forward_train(params, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()}, cfg)
    _close(got, want, tol, "loss")
    assert float(aux) == 0.0
    if S <= cfg.num_patch_tokens:
        assert float(got) == 0.0
    else:  # the patch targets do not move it
        moved = dict(batch, targets=batch["targets"].copy())
        moved["targets"][:, :cfg.num_patch_tokens] = 0
        with torch.no_grad():
            again, _ = transformer.forward_train(params, {k: torch.from_numpy(v)
                                                          for k, v in moved.items()}, cfg)
        assert float(again) == float(got)


def test_one_adamw_step_matches_the_reference():
    cfg, params, jcfg, np_params = _models()
    batch = _batch(cfg, seed=5)
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
    assert float(np.abs(want_p["patch_proj/w"] - np.asarray(np_params["patch_proj"]["w"])).max()) > 0
    for path, leaf in flatten(state["params"]).items():
        _close(leaf.detach(), want_p[path], TOL_F32, path)


def test_a_vlm_prompt_is_never_chunked(monkeypatch):
    """With ``PREFILL_CHUNK`` at 8 a 16-token VLM prompt runs one pass in
    both packages (the patch prefix spans the chunks): logits and cache as
    the reference's, with the patches in; a decoder without patches is
    chunked at the same length."""
    monkeypatch.setattr(transformer, "PREFILL_CHUNK", 8)
    monkeypatch.setattr(jT, "PREFILL_CHUNK", 8)
    cfg, params, jcfg, np_params = _models()
    batch = _batch(cfg, S=16)
    passes = []
    real = transformer._apply_blocks

    def spy(*a, **k):
        passes.append(a[1].shape[1])
        return real(*a, **k)

    monkeypatch.setattr(transformer, "_apply_blocks", spy)
    jlogits, jcache = jax.jit(lambda p, b, c: jT.prefill(p, b, jcfg, c))(
        np_params, {k: jnp.asarray(v) for k, v in batch.items()}, jT.init_cache(jcfg, 2, 20))
    logits, cache = transformer.prefill(params, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()}, cfg,
                                        transformer.init_cache(cfg, 2, 20, "cpu"))
    assert passes == [16]
    _close(logits, jlogits, TOL_F32, "logits")
    want = flatten(jax.device_get(jcache))
    for path, leaf in flatten(cache).items():
        _close(leaf, want[path], TOL_F32, path)
    passes.clear()
    plain = dataclasses.replace(cfg, num_patch_tokens=0, frontend_dim=0)
    transformer.prefill(params, {"tokens": torch.from_numpy(batch["tokens"])}, plain,
                        transformer.init_cache(plain, 2, 20, "cpu"))
    assert passes == [8, 8]
