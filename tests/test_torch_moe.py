"""The port's mixture of experts (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``): twins of ``tests/test_moe_dispatch.py``,
``apply_moe``'s output and aux loss on both dispatch routes with capacity
drops, padding rows, an all-tie router and shared experts, and the twin of
``tests/test_archs_smoke.py::test_moe_aux_loss_nonzero``.  Weights are the
reference's own (``init_moe``), carried across with ``from_jax``.

Tolerance: MoE outputs in fp32 within the reference's own 2e-5
(``tests/test_moe_dispatch.py``), the aux loss within 1e-6 relative."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
import repro.models.transformer as jT  # noqa: E402
from repro.config import AttentionConfig as JaxAttentionConfig  # noqa: E402
from repro.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.config import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, get_arch  # noqa: E402
from repro_torch.convert import from_jax, lm_params_from_jax  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402

TOL = 2e-5


def mk_cfgs(E=6, K=2, f=32, d=64, pad=0, dispatch="einsum", group=64, shared=0, shared_f=0):
    """(port, reference) configs of ``tests/test_moe_dispatch.py``'s ``mk_cfg``."""
    def one(Model, Attn, MoE):
        return Model(name="moe-test", family="decoder", num_layers=2, d_model=d, d_ff=f,
                     vocab_size=128, dtype="float32",
                     attention=Attn(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
                     moe=MoE(num_experts=E, top_k=K, expert_d_ff=f, pad_experts_to=pad,
                             dispatch=dispatch, group_size=group,
                             num_shared_experts=shared, shared_d_ff=shared_f))
    return (one(ModelConfig, AttentionConfig, MoEConfig),
            one(JaxModelConfig, JaxAttentionConfig, JaxMoEConfig))


def _with(cfg, **moe_kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))


def _weights(jcfg, seed=0):
    """The reference's init_moe as numpy, and the port's copy."""
    np_p = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    return np_p, from_jax(np_p, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(cfg, jcfg, p, np_p, x):
    """(port y, port aux, reference y, reference aux) as numpy."""
    y, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    jy, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, np_p), jnp.asarray(x), jcfg)
    return y.numpy(), float(aux), np.asarray(jy), float(jaux)


def _dropped(cfg, p, x, monkeypatch):
    """How many assignments the port's routing dropped on ``x``."""
    seen = []
    real = moe._router_assignments

    def spy(*args):
        out = real(*args)
        seen.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(moe, "_router_assignments", spy)
    moe.apply_moe(p, torch.from_numpy(x), cfg)
    monkeypatch.undo()
    return sum(seen)


# ---------------------------------------------------------------------------
# twins of tests/test_moe_dispatch.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", [0, 8])
def test_gather_equals_einsum(pad):
    cfg, jcfg = mk_cfgs(pad=pad)
    np_p, p = _weights(jcfg)
    x = torch.from_numpy(_x((2, 32, cfg.d_model), 1))
    y1, a1 = moe.apply_moe(p, x, cfg)
    y2, a2 = moe.apply_moe(p, x, _with(cfg, dispatch="gather"))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-5)


def test_padded_experts_receive_no_tokens():
    """Padding experts exist only for divisibility: the output equals the
    unpadded model's with the same weights, and ``init_moe`` stacks the
    padded count as the reference does."""
    cfg, _ = mk_cfgs(pad=0)
    cfg_pad, jcfg_pad = mk_cfgs(pad=8)
    np_p, p = _weights(jcfg_pad)
    assert moe.phys_experts(cfg_pad.moe) == jmoe.phys_experts(jcfg_pad.moe) == 8
    mine = moe.init_moe(torch.Generator().manual_seed(0), cfg_pad)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in np_p.items()}
    p_unpadded = {"router": p["router"], **{k: p[k][:6] for k in ("w_gate", "w_up", "w_down")}}
    x = torch.from_numpy(_x((1, 16, cfg.d_model), 2))
    y_pad, _ = moe.apply_moe(p, x, cfg_pad)
    y, _ = moe.apply_moe(p_unpadded, x, cfg)
    np.testing.assert_allclose(y_pad.numpy(), y.numpy(), atol=TOL, rtol=TOL)


def test_group_size_changes_only_capacity_drops():
    """With generous capacity nothing is dropped, so the grouping changes
    only the tokens whose assignments were dropped; most tokens agree."""
    cfg_a, jcfg_a = mk_cfgs(group=16)
    cfg_b, _ = mk_cfgs(group=64)
    _, p = _weights(jcfg_a)
    x = torch.from_numpy(_x((1, 64, cfg_a.d_model), 3))
    y_a, _ = moe.apply_moe(p, x, cfg_a)
    y_b, _ = moe.apply_moe(p, x, cfg_b)
    assert y_a.shape == y_b.shape
    close = np.isclose(y_a.numpy(), y_b.numpy(), atol=TOL).all(axis=-1)
    assert close.mean() > 0.7


@settings(max_examples=15, deadline=None, database=None, derandomize=True)
@given(
    E=st.sampled_from([4, 6, 8]),
    K=st.integers(1, 3),
    n_tok=st.sampled_from([8, 24, 64]),
    dispatch=st.sampled_from(["einsum", "gather"]),
)
def test_moe_invariants(E, K, n_tok, dispatch):
    """The reference's invariants, and each example equal to the reference."""
    cfg, jcfg = mk_cfgs(E=E, K=min(K, E), dispatch=dispatch, group=32)
    np_p, p = _weights(jcfg)
    x = _x((1, n_tok, cfg.d_model), 4)
    y, aux, jy, jaux = _both(cfg, jcfg, p, np_p, x)
    assert y.shape == x.shape
    assert np.isfinite(y).all()
    assert 0.0 <= aux < 10.0
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


# ---------------------------------------------------------------------------
# apply_moe against the reference
# ---------------------------------------------------------------------------


def _case(name):
    """(port cfg, reference cfg, x, port params, reference params as numpy,
    whether the case must drop assignments)."""
    if name == "drops":  # tokens all alike: every one picks the same experts
        cfg, jcfg = mk_cfgs(group=32)
        x = np.ones((2, 32, cfg.d_model), np.float32) + 0.01 * _x((2, 32, cfg.d_model), 5)
        np_p, p = _weights(jcfg)
        return cfg, jcfg, x, p, np_p, True
    if name == "padding_rows":  # 37 tokens in groups of 16: 3 groups of 13, 2 zero rows
        cfg, jcfg = mk_cfgs(group=16)
        np_p, p = _weights(jcfg)
        return cfg, jcfg, _x((1, 37, cfg.d_model), 6), p, np_p, False
    if name == "all_tie_router":  # zero router: every expert ties, the lowest K win
        cfg, jcfg = mk_cfgs(group=32)
        np_p, _ = _weights(jcfg)
        np_p = dict(np_p, router=np.zeros_like(np_p["router"]))
        return cfg, jcfg, _x((2, 24, cfg.d_model), 7), from_jax(np_p, "cpu"), np_p, True
    if name == "shared_experts":
        cfg, jcfg = mk_cfgs(group=32, shared=2, shared_f=48)
        np_p, p = _weights(jcfg)
        assert p["shared"]["w_gate"].shape == (cfg.d_model, 48)
        return cfg, jcfg, _x((2, 20, cfg.d_model), 8), p, np_p, False
    raise ValueError(name)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("name", ["drops", "padding_rows", "all_tie_router", "shared_experts"])
def test_apply_moe_matches_the_reference(name, dispatch, monkeypatch):
    cfg, jcfg, x, p, np_p, drops = _case(name)
    cfg, jcfg = _with(cfg, dispatch=dispatch), _with(jcfg, dispatch=dispatch)
    if drops:
        assert _dropped(cfg, p, x, monkeypatch) > 0
    y, aux, jy, jaux = _both(cfg, jcfg, p, np_p, x)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    assert aux > 0


def test_all_tie_router_takes_the_lowest_indices():
    """``jax.lax.top_k`` takes the lowest index among equal values; so does
    the port's routing, on a zero router where all experts tie."""
    cfg, jcfg, x, p, _, _ = _case("all_tie_router")
    xg = torch.from_numpy(x).reshape(2, 24, cfg.d_model)
    top_w, top_e, *_ = moe._router_assignments(p, xg, cfg.moe, 4)
    assert (top_e == torch.arange(cfg.moe.top_k)).all()
    np.testing.assert_allclose(top_w.numpy(), 1.0 / cfg.moe.top_k)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_moe_aux_loss_nonzero():
    """Twin of ``tests/test_archs_smoke.py::test_moe_aux_loss_nonzero``
    (qwen2-moe-a2.7b smoke, its own bf16), from the reference's weights."""
    jcfg, cfg = jax_get_arch("qwen2-moe-a2.7b", smoke=True), get_arch("qwen2-moe-a2.7b",
                                                                       smoke=True)
    params = lm_params_from_jax(jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg)),
                                "cpu", requires_grad=False)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
             for k in ("tokens", "targets")}
    with torch.no_grad():
        loss, aux = transformer.forward_train(params, batch, cfg)
    assert float(aux) > 0.0 and np.isfinite(float(loss))
    assert transformer.layer_kinds(cfg) == [("attn", "moe")] * cfg.num_layers
