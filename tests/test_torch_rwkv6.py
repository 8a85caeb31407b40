"""The RWKV-6 slice in the port against the JAX reference: the rwkv6-7b
configs, the time-mix (chunked and sequential scans, and the ``wkv_impl``
hook given the port's WKV wrapper) and channel-mix layers, the cache branch
with a nonzero state, the forward loss, gradients, AdamW steps, the weight
conversion and the launcher, all from the reference's own initial weights
carried across with ``lm_params_from_jax``."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.rwkv6 as jrwkv6  # noqa: E402
import repro.models.transformer as jT  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.config import RWKVConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import from_jax, lm_params_from_jax, to_jax  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.models import layers, rwkv6, transformer  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    init_train_state,
    lm_train_state,
    make_eval_step,
    make_train_step,
)
from repro_torch.tree import flatten, leaves  # noqa: E402

ARCH = "rwkv6-7b"
F32 = dict(dtype="float32")


def _cfgs(**kw):
    """(port, reference) rwkv6-7b smoke configs with the same overrides."""
    return (dataclasses.replace(get_arch(ARCH, smoke=True), **kw),
            dataclasses.replace(jax_get_arch(ARCH, smoke=True), **kw))


def _batch(vocab, B=2, S=24, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _init(jcfg, seed=0):
    """The reference's initial weights as numpy (jitted: eager init is slow)."""
    return jax.device_get(jax.jit(jT.init_lm, static_argnums=1)(jax.random.PRNGKey(seed), jcfg))


def _weights(jcfg, seed=0):
    np_params = _init(jcfg, seed)
    return np_params, lm_params_from_jax(np_params, "cpu")


@contextlib.contextmanager
def _precision(dtype):
    """``float32`` as written, or ``float64``: JAX with x64 on, and every fp32
    the two packages name (``jnp.float32``, ``torch.float32``,
    ``Tensor.float``, the port's dtype table) read as float64, so that the
    two packages differ by float64 rounding only.  A gap between them that
    shrinks by as much as float64 rounding does is rounding, not a
    difference in the arithmetic."""
    if dtype == "float32":
        yield
        return
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jnp, "float32", jnp.float64)
        mp.setattr(torch, "float32", torch.float64)
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        mp.setitem(layers._DTYPES, "float32", torch.float64)
        mp.setitem(layers._DTYPES, "float64", torch.float64)
        yield


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_rwkv_configs_match_the_reference():
    for smoke in (False, True):
        got, want = get_arch(ARCH, smoke=smoke), jax_get_arch(ARCH, smoke=smoke)
        for f in dataclasses.fields(got):
            if f.name != "rwkv":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        for f in dataclasses.fields(RWKVConfig):
            assert getattr(got.rwkv, f.name) == getattr(want.rwkv, f.name), f.name
    full = get_arch(ARCH)
    assert (full.num_layers, full.d_model, full.d_ff, full.vocab_size) == (32, 4096, 14336, 65536)
    assert full.d_model // full.rwkv.head_dim == 64 and full.rwkv.decay_lora == 64
    assert transformer.layer_kinds(full) == [("rwkv", "rwkv_cm")] * 32
    assert transformer.period(full) == 1


def test_init_lm_tree_matches_the_reference():
    """The port draws its own weights, in the reference's tree: the same
    paths and shapes (blocks stacked over layers, tm and cm per sublayer)."""
    cfg, jcfg = _cfgs()
    want = flatten(jax.eval_shape(lambda: jT.init_lm(jax.random.PRNGKey(0), jcfg)))
    got = flatten(transformer.init_lm(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert list(got) == list(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
    assert "blocks/sub0/tm/lora_b" in got and "blocks/sub0/cm/w_k" in got


def _layer_inputs(jcfg, S, seed=2):
    """One time-mix and one channel-mix of the reference's init, and an fp32
    input x (B, S, d)."""
    ktm, kcm = jax.random.split(jax.random.PRNGKey(seed))
    tm = jax.device_get(jrwkv6.init_rwkv_timemix(ktm, jcfg))
    cm = jax.device_get(jrwkv6.init_rwkv_channelmix(kcm, jcfg))
    x = np.random.default_rng(seed).standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    return tm, cm, x


def _jax_wkv_interpret(*args):
    from repro.kernels.rwkv6_wkv.ops import wkv

    return wkv(*args, interpret=True)


@pytest.mark.parametrize("mode", ["chunk", "seq", "wkv_impl"])
@pytest.mark.parametrize("S", [32, 40])
def test_timemix_matches_jax(mode, S):
    """fp32, 1e-5.  ``wkv_impl`` hands the port's ``wkv`` (its plain version
    here) to the port's layer and the reference's kernel in interpret mode
    to the reference's; S = 40 is off the 32-token chunk grid."""
    cfg, jcfg = _cfgs(**F32)
    tm, _, x = _layer_inputs(jcfg, S)
    kw = {"wkv_impl": wkv_ops.wkv} if mode == "wkv_impl" else {"scan_mode": mode}
    jkw = {"wkv_impl": _jax_wkv_interpret} if mode == "wkv_impl" else {"scan_mode": mode}
    before = wkv_ops.wkv.launches
    got, cache = rwkv6.apply_rwkv_timemix(from_jax(tm, "cpu"), torch.from_numpy(x), cfg, **kw)
    want, _ = jrwkv6.apply_rwkv_timemix(tm, jnp.asarray(x), jcfg, **jkw)
    assert cache is None and wkv_ops.wkv.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_channelmix_matches_jax():
    cfg, jcfg = _cfgs(**F32)
    _, cm, x = _layer_inputs(jcfg, 24)
    got, _ = rwkv6.apply_rwkv_channelmix(from_jax(cm, "cpu"), torch.from_numpy(x), cfg)
    want, _ = jrwkv6.apply_rwkv_channelmix(cm, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,mode", [(1, "seq"), (8, "chunk"), (8, "wkv_impl")])
def test_cache_branch_with_a_nonzero_state_matches_jax(S, mode):
    """The cache carries a nonzero WKV state and token-shift streams in:
    decode (S = 1) and a prefill-like chunk, through the plain scans and
    through the port's ``wkv`` (a nonzero s0); outputs and new caches, 1e-5."""
    cfg, jcfg = _cfgs(**F32)
    tm, cm, x = _layer_inputs(jcfg, S)
    rng = np.random.default_rng(5)
    np_cache = jax.device_get(jrwkv6.init_rwkv_cache(jcfg, 2))
    np_cache = {k: rng.standard_normal(v.shape, dtype=np.float32) * 0.3
                for k, v in np_cache.items()}
    cache = from_jax(np_cache, "cpu")
    assert {k: tuple(v.shape) for k, v in rwkv6.init_rwkv_cache(cfg, 2, "cpu").items()} == \
        {k: v.shape for k, v in np_cache.items()}
    kw = {"wkv_impl": wkv_ops.wkv} if mode == "wkv_impl" else {"scan_mode": mode}
    jkw = {"wkv_impl": _jax_wkv_interpret} if mode == "wkv_impl" else {"scan_mode": mode}
    got, new = rwkv6.apply_rwkv_timemix(from_jax(tm, "cpu"), torch.from_numpy(x), cfg,
                                        cache=cache, **kw)
    want, jnew = jrwkv6.apply_rwkv_timemix(tm, jnp.asarray(x), jcfg,
                                           cache=jax.tree.map(jnp.asarray, np_cache), **jkw)
    tol = 5e-4 if mode == "wkv_impl" else 1e-5  # the reference kernel folds s0 in (5e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    for key in ("state", "shift_tm"):
        np.testing.assert_allclose(new[key].numpy(), np.asarray(jnew[key]), rtol=tol, atol=tol,
                                   err_msg=key)
    got, new = rwkv6.apply_rwkv_channelmix(from_jax(cm, "cpu"), torch.from_numpy(x), cfg,
                                           cache=cache)
    want, jnew = jrwkv6.apply_rwkv_channelmix(cm, jnp.asarray(x), jcfg,
                                              cache=jax.tree.map(jnp.asarray, np_cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new["shift_cm"].numpy(), np.asarray(jnew["shift_cm"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("overrides,atol", [
    (F32, 1e-5),
    ({}, 5e-3),  # bf16 compute: the two frameworks round at other places
])
def test_forward_loss_matches_jax(overrides, atol):
    """S = 24, off the chunk grid, as tests/test_archs_smoke.py runs it; the
    bf16 atol is the one tests/test_torch_lm.py holds granite to."""
    cfg, jcfg = _cfgs(**overrides)
    np_params, params = _weights(jcfg)
    batch = _batch(cfg.vocab_size)
    want, _ = jT.forward_train(np_params, _j(batch), jcfg)
    got, aux = transformer.forward_train(params, _t(batch), cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=atol)
    assert make_eval_step(cfg)(params, _t(batch))["loss"].item() == got.item()


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


# (precision, tolerance of the parameters).  In fp32, AdamW divides each
# gradient element by its own RMS, so an element whose gradient sits at
# fp32's noise floor (|g| ~ 1e-6, where the packages' summation orders differ
# by ~1e-7, test_gradients_match_jax) moves by a different fraction of the
# 1e-3 step: the packages' parameters differ by up to 1.44e-4 after two
# steps.  The same run in float64 holds them to 1e-10: the fp32 gap is
# rounding.
ADAMW_CASES = [("float32", 2e-4), ("float64", 1e-10)]


@pytest.mark.parametrize("precision,atol", ADAMW_CASES)
def test_two_adamw_steps_match_jax(precision, atol):
    """Two AdamW steps at lr 1e-3 from the reference's fp32 initial weights;
    losses and grad norms within 1e-4 in fp32 (1e-10 in float64)."""
    np_params = _init(_cfgs(**F32)[1])
    with _precision(precision):
        cfg, jcfg = _cfgs(dtype=precision, param_dtype=precision)
        np_params = jax.tree.map(lambda a: a.astype(precision), np_params)
        params = lm_params_from_jax(np_params, "cpu")
        hp = dict(optimizer="adamw", learning_rate=1e-3, warmup_steps=1, total_steps=10,
                  weight_decay=1e-2)
        jt, tcfg = JaxTrainConfig(**hp), TrainConfig(**hp)
        jstate = {"params": jax.tree.map(jnp.asarray, np_params),
                  "opt": jax_make_optimizer(jt).init(np_params),
                  "step": jnp.zeros((), jnp.int32)}
        state = lm_train_state(params, tcfg)
        jstep, step = jax.jit(jax_make_train_step(jcfg, jt)), make_train_step(cfg, tcfg)
        tol = min(atol, 1e-4)
        for i in range(2):
            batch = _batch(cfg.vocab_size, B=4, seed=10 + i)
            jstate, jm = jstep(jstate, _j(batch))
            state, m = step(state, _t(batch))
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=tol, atol=tol,
                                           err_msg=k)
        got, want = flatten(to_jax(state["params"])), flatten(jax.device_get(jstate["params"]))
    for path in want:
        assert got[path].dtype == want[path].dtype == np.dtype(precision), path
        np.testing.assert_allclose(got[path], want[path], rtol=tol, atol=atol, err_msg=path)


def test_convert_keeps_the_rwkv_leaves():
    """``lm_params_from_jax`` carries the RWKV tree as it is: the stacked
    (L, d, H, D) einsum weights and every tm/cm leaf keep shape, value and
    path, and round-trip."""
    _, jcfg = _cfgs()
    np_params = _init(jcfg)
    assert np_params["blocks"]["sub0"]["tm"]["w_r"].shape == (2, 64, 4, 16)
    params = lm_params_from_jax(np_params, "cpu")
    want, got = flatten(np_params), flatten(to_jax(params))
    assert list(got) == list(want)
    assert sum(p.startswith("blocks/sub0/tm/") for p in got) == 16
    assert sum(p.startswith("blocks/sub0/cm/") for p in got) == 5
    for path in want:
        assert got[path].shape == want[path].shape
        np.testing.assert_array_equal(got[path], want[path])
    assert all(p.requires_grad for p in leaves(params))


ITEMS, BS, SEQ, STEPS, LR = 12, 4, 40, 4, 1e-3  # 3 batches an epoch: the run crosses one
# (precision, tolerance of the histories).  fp32 rounding, amplified by AdamW
# (test_two_adamw_steps_match_jax), reaches the grad norm of the 4th step at
# 1.07e-4 relative; in float64 the same run agrees to 1e-10.
LAUNCH_CASES = [("float32", 2e-4), ("float64", 1e-10)]


@pytest.mark.parametrize("precision,tol", LAUNCH_CASES)
def test_launcher_matches_jax_trainer(monkeypatch, precision, tol):
    """``--arch rwkv6-7b`` trains the smoke model from packed token sequences
    behind simulated S3, two microbatches a step, in fp32 (and float64) so
    the histories compare closely (40 tokens: off the chunk grid), at the
    learning rate the granite twin in test_torch_launch.py uses.  Losses
    agree within 1e-4 in fp32."""
    from repro.config import LoaderConfig as JaxLoaderConfig
    from repro.config import StoreConfig as JaxStoreConfig
    from repro.config import replace as jax_replace
    from repro.core.loader import ConcurrentDataLoader as JaxLoader
    from repro.data.dataset import TokenDataset as JaxTokenDataset
    from repro.data.dataset import build_token_store as jax_build_tokens
    from repro.data.store import InMemoryStore as JaxInMemoryStore
    from repro.data.store import build_store as jax_build_store
    from repro.train.trainer import Trainer as JaxTrainer
    from repro_torch.config import register_arch, replace
    from repro_torch.configs import rwkv6_7b
    from repro_torch.launch import train as launch

    arch = f"rwkv6-7b-{precision}"
    register_arch(arch, rwkv6_7b.full, lambda: replace(
        rwkv6_7b.smoke(), dtype=precision, param_dtype=precision))
    np_params = _init(_cfgs(**F32)[1])
    with _precision(precision):
        jcfg = jax_replace(jax_get_arch(ARCH, smoke=True), dtype=precision, param_dtype=precision)
        jt = JaxTrainConfig(optimizer="adamw", learning_rate=LR, microbatches=2,
                            total_steps=STEPS)
        np_params = jax.tree.map(lambda a: a.astype(precision), np_params)
        monkeypatch.setattr(launch, "init_train_state", lambda cfg, tcfg, generator, device:
                            lm_train_state(lm_params_from_jax(np_params, device), tcfg))
        report = launch.run([
            "--arch", arch, "--device", "cpu", "--items", str(ITEMS), "--batch-size", str(BS),
            "--seq-len", str(SEQ), "--steps", str(STEPS), "--latency", "0.001",
            "--optimizer", "adamw", "--lr", str(LR), "--microbatches", "2", "--workers", "2",
            "--fetchers", "2"])

        base = JaxInMemoryStore()
        jax_build_tokens(base, ITEMS, SEQ, jcfg.vocab_size)
        store = jax_build_store(JaxStoreConfig(kind="s3sim", latency_mean_s=0.001), base=base)
        loader = JaxLoader(JaxTokenDataset(store, ITEMS, SEQ),
                           JaxLoaderConfig(impl="threaded", batch_size=BS, num_workers=2,
                                           num_fetch_workers=2, seed=0))
        jstate = {"params": np_params, "opt": jax_make_optimizer(jt).init(np_params),
                  "step": jnp.zeros((), jnp.int32)}
        want = JaxTrainer(jax_make_train_step(jcfg, jt), jstate).fit(
            loader, epochs=100, max_steps=STEPS)

    got = report.result
    assert got.steps == want.steps == STEPS and got.epochs == want.epochs == 2
    assert all(p.dtype == getattr(torch, precision) for p in leaves(report.state["params"]))
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in want.history],
                               rtol=min(tol, 1e-4), atol=min(tol, 1e-4), err_msg="loss")
    np.testing.assert_allclose([h["grad_norm"] for h in got.history],
                               [h["grad_norm"] for h in want.history],
                               rtol=tol, atol=tol, err_msg="grad_norm")


def test_launcher_trains_the_smoke_model_in_bf16():
    """The README's command: ``--arch rwkv6-7b --device cpu`` at smoke size,
    bf16 compute, from the port's own initial weights; every loss finite."""
    from repro_torch.launch import train as launch

    report = launch.run(["--arch", ARCH, "--device", "cpu", "--items", "8", "--batch-size", "4",
                         "--seq-len", "24", "--steps", "3", "--microbatches", "2",
                         "--latency", "0.001", "--workers", "2", "--fetchers", "2"])
    assert report.cfg.family == "rwkv" and report.result.steps == 3
    assert all(np.isfinite(h["loss"]) for h in report.result.history)
    state = init_train_state(report.cfg, TrainConfig(), torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in leaves(state["params"])) == sum(
        p.numel() for p in leaves(report.state["params"]))
