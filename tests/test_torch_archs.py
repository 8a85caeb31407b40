"""Twins of ``tests/test_archs_smoke.py`` on the port alone: the registry
holds the ten assigned architectures and resnet, each trains one AdamW
step at its smoke config (a finite loss, a positive gradient norm, the
step counted, and the parameters moved), and each LM and the
encoder-decoder prefills and decodes (logits of the vocabulary's width,
finite).  Batches are drawn from a seed with numpy; each family is held
to the reference itself in its own ``tests/test_torch_*.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.config import TrainConfig, get_arch, list_archs  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.models import encdec, transformer  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    init_resnet_train_state,
    init_train_state,
    make_resnet_train_step,
    make_train_step,
)
from repro_torch.tree import leaves  # noqa: E402

TCFG = TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=1)
B, S = 2, 24


def make_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.family == "resnet":
        return {"image": torch.from_numpy(rng.standard_normal((B, 3, 32, 32)).astype(np.float32)),
                "label": torch.from_numpy(rng.integers(0, cfg.num_classes, (B,)).astype(np.int32))}
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
             for k in ("tokens", "targets")}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    if cfg.num_patch_tokens:
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.frontend_dim)).astype(np.float32))
    return batch


def test_registry_has_all_assigned():
    names = list_archs()
    for a in ASSIGNED:
        assert a in names
    assert "resnet18-imagenet" in names
    assert len(ASSIGNED) == 10 and len(names) == 11


@pytest.mark.parametrize("name", list(ASSIGNED) + ["resnet18-imagenet"])
def test_arch_one_train_step(name):
    cfg = get_arch(name, smoke=True)
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "resnet":
        state = init_resnet_train_state(cfg, TCFG, gen, "cpu")
        step = make_resnet_train_step(cfg, TCFG)
    else:
        state = init_train_state(cfg, TCFG, gen, "cpu")
        step = make_train_step(cfg, TCFG)
    before = [p.detach().clone() for p in leaves(state["params"])]
    state, m = step(state, make_batch(cfg))
    assert np.isfinite(float(m["loss"])), name
    assert float(m["grad_norm"]) > 0
    assert state["step"] == 1
    after = leaves(state["params"])
    assert all(torch.isfinite(p).all() for p in after)
    assert any(not torch.equal(a.detach(), b) for a, b in zip(after, before))


@pytest.mark.parametrize("name", list(ASSIGNED))
def test_arch_prefill_decode(name):
    cfg = get_arch(name, smoke=True)
    gen = torch.Generator().manual_seed(0)
    batch = make_batch(cfg)
    model, init_cache = (encdec, encdec.init_dec_cache) if cfg.family == "encdec" else \
        (transformer, transformer.init_cache)
    params = encdec.init_encdec(cfg, gen, "cpu") if cfg.family == "encdec" else \
        transformer.init_lm(cfg, gen, "cpu")
    logits, cache = model.prefill(params, batch, cfg, init_cache(cfg, B, S + 8, "cpu"))
    logits2, cache = model.decode_step(params, cache, batch["tokens"][:, -1:], S, cfg)
    assert tuple(logits.shape) == (B, cfg.vocab_size)
    assert tuple(logits2.shape) == (B, cfg.vocab_size)
    assert torch.isfinite(logits2.float()).all(), name
