"""The dense-decoder LM slice in the port against the JAX reference: the
granite-8b configs, forward loss, the q-chunked attention path, the flash
route, gradients and train steps (AdamW, Adafactor, microbatches,
compression), all from the reference's own initial weights carried across
with ``lm_params_from_jax``."""
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
from repro.train import compression as jcompression  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.config import AttentionConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_jax,
    to_jax,
    resnet_state_from_jax,
)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.train import compression  # noqa: E402
from repro_torch.train.optim import make_optimizer  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    init_train_state,
    lm_train_state,
    make_eval_step,
    make_train_step,
)
from repro_torch.tree import flatten, leaves  # noqa: E402

F32 = dict(dtype="float32")


def _cfgs(**kw):
    """(port, reference) granite-8b smoke configs with the same overrides."""
    return (dataclasses.replace(get_arch("granite-8b", smoke=True), **kw),
            dataclasses.replace(jax_get_arch("granite-8b", smoke=True), **kw))


def _batch(vocab, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _weights(jcfg, seed=0):
    """The reference's initial weights as numpy, and the port's copy."""
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(seed), jcfg))
    return np_params, lm_params_from_jax(np_params, "cpu")


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_granite_configs_match_the_reference():
    for smoke in (False, True):
        got, want = get_arch("granite-8b", smoke=smoke), jax_get_arch("granite-8b", smoke=smoke)
        for f in dataclasses.fields(got):
            if f.name != "attention":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        for f in dataclasses.fields(AttentionConfig):
            assert getattr(got.attention, f.name) == getattr(want.attention, f.name), f.name
    assert TrainConfig().microbatches == JaxTrainConfig().microbatches == 1
    assert TrainConfig().grad_compression == JaxTrainConfig().grad_compression == "none"


@pytest.mark.parametrize("overrides,atol", [
    (F32, 1e-5),
    ({}, 5e-3),  # bf16 compute: the two frameworks round at other places
    (dict(F32, mlp="relu2", norm="layernorm"), 1e-5),
    (dict(F32, mlp="gelu", tie_embeddings=True, remat=False), 1e-5),
    (dict(F32, attention=AttentionConfig(kind="mha", num_heads=4, num_kv_heads=4,
                                         head_dim=16, rope=False)), 1e-5),
])
def test_forward_loss_matches_jax(overrides, atol):
    if "attention" in overrides:  # the reference's own AttentionConfig type
        a = overrides["attention"]
        overrides = dict(overrides, attention=jax_get_arch("granite-8b", smoke=True).attention)
        cfg, jcfg = _cfgs(**overrides)
        jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
            jcfg.attention, **{f.name: getattr(a, f.name) for f in dataclasses.fields(a)}))
        cfg = dataclasses.replace(cfg, attention=a)
    else:
        cfg, jcfg = _cfgs(**overrides)
    np_params, params = _weights(jcfg)
    batch = _batch(cfg.vocab_size)
    want, _ = jT.forward_train(np_params, _j(batch), jcfg)
    got, aux = transformer.forward_train(params, _t(batch), cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=atol)


def test_chunked_attention_at_4096_matches_jax(monkeypatch):
    """S = 4096 takes ``_sdpa_chunked`` in both packages (narrow width)."""
    kw = dict(F32, num_layers=1, d_model=32, d_ff=64, vocab_size=64)
    cfg, jcfg = _cfgs(**kw)
    cfg = dataclasses.replace(cfg, attention=AttentionConfig(
        kind="gqa", num_heads=2, num_kv_heads=1, head_dim=16))
    jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
        jcfg.attention, num_heads=2, num_kv_heads=1, head_dim=16))
    calls = {"port": 0, "jax": 0}

    def counting(mod, key):
        fn = mod._sdpa_chunked

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, "_sdpa_chunked", wrapped)

    counting(layers, "port")
    counting(jlayers, "jax")
    np_params, params = _weights(jcfg)
    batch = _batch(cfg.vocab_size, B=1, S=4096)
    want, _ = jT.forward_train(np_params, _j(batch), jcfg)
    with torch.no_grad():
        got, _ = transformer.forward_train(params, _t(batch), cfg)
    assert calls == {"port": 1, "jax": 1}
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)


def test_flash_route_matches_ref_loss_and_refuses_training():
    """``attention_impl="pallas"`` routes self-attention through
    ``flash_attention`` (its plain version on the CPU) within the 5e-3 of
    tests/test_kernels.py:183; it is forward-only."""
    cfg, jcfg = _cfgs()
    pallas = dataclasses.replace(cfg, attention_impl="pallas")
    _, params = _weights(jcfg)
    batch = _t(_batch(cfg.vocab_size))
    seen = []
    real = flash_ops.flash_attention

    def spy(q, k, v, causal=True):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, causal)

    flash_ops.flash_attention = spy
    try:
        got = make_eval_step(pallas)(params, batch)["loss"].item()
        with pytest.raises(RuntimeError, match="forward-only"):
            transformer.forward_train(params, batch, pallas)  # params require grad
    finally:
        flash_ops.flash_attention = real
    want = make_eval_step(cfg)(params, batch)["loss"].item()
    assert seen[:cfg.num_layers] == [((2, 4, 32, 16), (2, 2, 32, 16))] * cfg.num_layers
    assert abs(got - want) < 5e-3
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(pallas, TrainConfig())


def test_gradients_match_jax():
    cfg, jcfg = _cfgs(**F32)
    np_params, params = _weights(jcfg)
    batch = _batch(cfg.vocab_size)
    jgrads = jax.grad(lambda p: jT.forward_train(p, _j(batch), jcfg)[0])(
        jax.tree.map(jnp.asarray, np_params))
    loss, _ = transformer.forward_train(params, _t(batch), cfg)
    grads = torch.autograd.grad(loss, leaves(params))
    want = flatten(jax.device_get(jgrads))
    assert list(flatten(params)) == list(want)
    for path, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4, atol=1e-4, err_msg=path)


HP = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, weight_decay=1e-2)


def _steps_match(optimizer, n=2, **extra):
    cfg, jcfg = _cfgs(**F32)
    np_params, params = _weights(jcfg)
    jt = JaxTrainConfig(optimizer=optimizer, **HP, **extra)
    tcfg = TrainConfig(optimizer=optimizer, **HP, **extra)
    jstate = {"params": jax.tree.map(jnp.asarray, np_params),
              "opt": jax_make_optimizer(jt).init(np_params), "step": jnp.zeros((), jnp.int32)}
    if extra.get("grad_compression") == "int8_ef":
        jstate["ef"] = jcompression.init_error_feedback(jstate["params"])
    state = lm_train_state(params, tcfg)
    jstep, step = jax.jit(jax_make_train_step(jcfg, jt)), make_train_step(cfg, tcfg)
    for i in range(n):
        batch = _batch(cfg.vocab_size, B=4, seed=10 + i)
        jstate, jm = jstep(jstate, _j(batch))
        state, m = step(state, _t(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    assert state["step"] == n
    got, want = flatten(to_jax(state["params"])), flatten(
        jax.device_get(jstate["params"]))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4, atol=1e-4, err_msg=path)
    return state, jstate


def test_two_adamw_steps_match_jax():
    state, jstate = _steps_match("adamw")
    got, want = flatten(to_jax(state["opt"])), flatten(jax.device_get(jstate["opt"]))
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4, atol=1e-6, err_msg=path)


def test_two_adafactor_steps_match_jax():
    _steps_match("adafactor")


@pytest.mark.parametrize("mode", ["bf16", "int8_ef"])
def test_compressed_steps_match_jax(mode):
    _steps_match("adamw", grad_compression=mode)


def test_microbatches_match_full_batch():
    """Twin of tests/test_train.py::test_grad_accum_matches_full_batch."""
    cfg, _ = _cfgs()
    t1 = TrainConfig(optimizer="sgd", learning_rate=0.1, microbatches=1, grad_clip=0.0,
                     warmup_steps=0, schedule="constant", weight_decay=0.0)
    t4 = dataclasses.replace(t1, microbatches=4)
    s1 = init_train_state(cfg, t1, torch.Generator().manual_seed(0), "cpu")
    s4 = init_train_state(cfg, t4, torch.Generator().manual_seed(0), "cpu")
    batch = _t(_batch(cfg.vocab_size, B=8, S=16))
    s1, m1 = make_train_step(cfg, t1)(s1, batch)
    s4, m4 = make_train_step(cfg, t4)(s4, batch)
    assert m1["loss"].item() == pytest.approx(m4["loss"].item(), rel=1e-4)
    for a, b in zip(leaves(s1["params"]), leaves(s4["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=5e-3, atol=7e-4)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, dataclasses.replace(t1, microbatches=3))(s1, batch)


def test_adafactor_state_is_factored():
    """Twin of tests/test_train.py's two Adafactor state tests."""
    opt = make_optimizer(TrainConfig(optimizer="adafactor", learning_rate=0.01,
                                     warmup_steps=0))
    p = {"w": torch.ones((8, 16)), "b": torch.ones((8,))}
    st = opt.init(p)
    assert st["v"]["w"]["vr"].shape == (8,) and st["v"]["w"]["vc"].shape == (16,)
    assert st["v"]["b"]["v"].shape == (8,)
    opt.update([torch.full((8,), 0.1), torch.full((8, 16), 0.1)], st, p, 0)  # leaf order
    assert torch.isfinite(p["w"]).all() and not torch.allclose(p["w"], torch.ones(8, 16))
    big = {"w": torch.ones((256, 512))}
    size = lambda t: sum(x.numel() for x in leaves(t))  # noqa: E731
    assert size(make_optimizer(TrainConfig(optimizer="adafactor")).init(big)) < size(
        make_optimizer(TrainConfig(optimizer="adamw")).init(big)) / 50


def test_compression_matches_jax():
    """Twins of tests/test_train.py's compression tests, and the same
    arithmetic as the reference on one gradient."""
    g = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    out, _ = compression.apply_compression([torch.from_numpy(g)], None, "bf16")
    np.testing.assert_allclose(out[0].numpy(), g, rtol=1e-2, atol=1e-2)
    want, _ = jcompression.apply_compression({"w": jnp.asarray(g)}, None, "bf16")
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want["w"]))
    ef = [torch.zeros(64)]
    jef = jcompression.init_error_feedback({"w": jnp.asarray(g)})
    for _ in range(3):
        out, ef = compression.apply_compression([torch.from_numpy(g)], ef, "int8_ef")
        jout, jef = jcompression.apply_compression({"w": jnp.asarray(g)}, jef, "int8_ef")
        np.testing.assert_allclose(out[0].numpy(), np.asarray(jout["w"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ef[0].numpy(), np.asarray(jef["w"]), rtol=1e-6, atol=1e-7)
    # error feedback makes the dequantized sum track the true sum
    small = [torch.full((16,), 0.00123)]
    ef, total = [torch.zeros(16)], torch.zeros(16)
    for _ in range(50):
        out, ef = compression.apply_compression(small, ef, "int8_ef")
        total += out[0]
    np.testing.assert_allclose(total.numpy(), 50 * 0.00123 * np.ones(16), rtol=0.05)
    with pytest.raises(ValueError, match="error-feedback"):
        compression.apply_compression(small, None, "int8_ef")


def test_convert_keeps_stacked_lm_leaves():
    """With stacked blocks the LM's wq is (L,d,H,hd) and wo (L,H,hd,d): 4-D,
    like a conv weight.  The ResNet's HWIO -> OIHW flip, which the port once
    applied to every 4-D leaf, scrambles them; the LM conversion keeps every
    shape and value, and round-trips."""
    _, jcfg = _cfgs()
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    wq = np_params["blocks"]["sub0"]["attn"]["wq"]
    assert wq.shape == (3, 64, 4, 16)
    flipped, _ = resnet_state_from_jax(np_params, {}, "cpu")
    assert tuple(flipped["blocks"]["sub0"]["attn"]["wq"].shape) == (16, 4, 3, 64)
    params = lm_params_from_jax(np_params, "cpu")
    want = flatten(np_params)
    got = flatten(to_jax(params))
    assert list(got) == list(want)
    for path in want:
        assert got[path].shape == want[path].shape
        np.testing.assert_array_equal(got[path], want[path])
    assert all(p.requires_grad for p in leaves(params))


def test_trainer_and_raw_loop_agree_on_synthetic_tokens():
    """Twin of tests/test_train.py::test_trainer_vs_raw_loop_same_result, on
    ``SyntheticTokenDataset``, whose items equal the reference's."""
    from repro.data.dataset import SyntheticTokenDataset as JaxSynthetic
    from repro_torch.config import LoaderConfig
    from repro_torch.core.loader import ConcurrentDataLoader
    from repro_torch.data.dataset import SyntheticTokenDataset
    from repro_torch.train.trainer import Trainer, raw_train_loop

    cfg, _ = _cfgs()
    ds = SyntheticTokenDataset(32, 16, cfg.vocab_size, seed=4)
    ref = JaxSynthetic(32, 16, cfg.vocab_size, seed=4)
    for i in (0, 7, 31):
        for k, v in ref[i].items():
            np.testing.assert_array_equal(ds[i][k], v, err_msg=k)
    tcfg = TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=1)
    lcfg = LoaderConfig(impl="threaded", batch_size=8, num_workers=2, seed=3)

    def fresh():
        return init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")

    r1 = Trainer(make_train_step(cfg, tcfg), fresh(), device="cpu").fit(
        ConcurrentDataLoader(ds, lcfg), epochs=1)
    r2 = raw_train_loop(make_train_step(cfg, tcfg), fresh(), ConcurrentDataLoader(ds, lcfg),
                        epochs=1, device="cpu")
    assert r1.steps == r2.steps == 4
    assert r1.last_metrics["loss"] == pytest.approx(r2.last_metrics["loss"], rel=1e-5)
