"""The port's serving engine and launcher against the JAX reference: twins
of ``tests/test_serve.py`` (the same greedy tokens as the reference's
``ServeEngine`` and its sequential batch-1 decode, from the reference's
own weights, in fp32; for the MLA, MoE and hybrid configs, the same tokens
as the reference's engine; for the encoder-decoder at 4 slots, the tokens
of the reference's one-slot engine, the only size it serves), the bf16
engine held to the reference's logits within a stated tolerance, and
``init_lm``'s fill-in-place.

Tolerance at the smoke config's bf16: the port's and the reference's
teacher-forced logits within 0.1 of each other (about 3 % of their 3.5
scale; measured 0.051), and each of the port's greedy tokens within 0.1 of
the reference's largest logit at its step (a tie at bf16's rounding; the
two frameworks round at other places, so exact tokens are asked in fp32)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jax_launch  # noqa: E402
import repro.models.encdec as jE  # noqa: E402
import repro.models.transformer as jT  # noqa: E402
from repro.config import ServeSpec as JaxServeSpec  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.config import ServeSpec, get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import encdec, moe, transformer  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.steps import greedy_sample, temperature_sample  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

TOL_BF16 = 0.1
SPEC = dict(num_slots=2, max_len=64)


class Model:
    """A smoke model in both packages from the reference's weights, with
    the reference's jitted batch-1 programs."""

    def __init__(self, arch, **kw):
        self.jcfg = dataclasses.replace(jax_get_arch(arch, smoke=True), **kw)
        self.cfg = dataclasses.replace(get_arch(arch, smoke=True), **kw)
        self.jparams = jT.init_lm(jax.random.PRNGKey(0), self.jcfg)
        self.params = lm_params_from_jax(jax.device_get(self.jparams), "cpu",
                                         requires_grad=False)
        self._prefill = jax.jit(lambda p, b, c: jT.prefill(p, b, self.jcfg, c))
        self._decode = jax.jit(lambda p, c, t, q: jT.decode_step(p, c, t, q, self.jcfg))

    def reference(self, prompt, n_new, forced=None):
        """The reference's sequential batch-1 decode (``reference_greedy`` of
        ``tests/test_serve.py``), fed its own greedy tokens or, teacher
        forcing, ``forced``: (its greedy tokens, each step's logits)."""
        logits, cache = self._prefill(self.jparams,
                                      {"tokens": jnp.asarray(prompt, jnp.int32)[None]},
                                      jT.init_cache(self.jcfg, 1, 64))
        steps = [np.asarray(logits[0], np.float32)]
        out = [int(np.argmax(steps[-1]))]
        for i in range(n_new - 1):
            fed = out[-1] if forced is None else forced[i]
            logits, cache = self._decode(self.jparams, cache, jnp.asarray([[fed]], jnp.int32),
                                         jnp.int32(len(prompt) + i))
            steps.append(np.asarray(logits[0], np.float32))
            out.append(int(np.argmax(steps[-1])))
        return out, np.stack(steps)

    def port_forced(self, prompt, forced):
        """The port's sequential batch-1 decode fed ``forced``: each step's logits."""
        logits, cache = transformer.prefill(self.params, {"tokens": torch.tensor([prompt])},
                                            self.cfg, transformer.init_cache(self.cfg, 1, 64,
                                                                             "cpu"))
        steps = [logits[0].float().numpy()]
        for i, tok in enumerate(forced[:-1]):
            logits, cache = transformer.decode_step(self.params, cache, torch.tensor([[tok]]),
                                                    len(prompt) + i, self.cfg)
            steps.append(logits[0].float().numpy())
        return np.stack(steps)

    def serve(self, submissions, spec=SPEC, jax_too=False):
        """The port's engine (and with ``jax_too`` the reference's) over the
        same submissions: (port engine, {uid: output}, {uid: reference output})."""
        eng = ServeEngine(self.cfg, self.params, spec=ServeSpec(**spec), device="cpu")
        jeng = JaxServeEngine(self.jcfg, self.jparams, spec=JaxServeSpec(**spec))
        for prompt, kw in submissions:
            eng.submit(prompt, **kw)
            if jax_too:
                jeng.submit(prompt, **kw)
        got = {r.uid: r.output for r in eng.run_until_drained()}
        want = {r.uid: r.output for r in jeng.run_until_drained()} if jax_too else None
        return eng, got, want


@pytest.fixture(scope="module")
def granite():
    return Model("granite-8b", dtype="float32")


# ---------------------------------------------------------------------------
# twins of tests/test_serve.py (fp32: exact tokens)
# ---------------------------------------------------------------------------


def test_engine_matches_reference(granite):
    prompts = [[5, 7, 11], [1, 2, 3], [9, 9, 9]]
    eng, got, _ = granite.serve([(p, dict(max_new_tokens=6)) for p in prompts])
    assert len(got) == 3
    for uid, p in zip(sorted(got), prompts):
        assert got[uid] == granite.reference(p, 6)[0], uid


def test_continuous_batching_refills_slots(granite):
    subs = [([1, 2, 3], dict(max_new_tokens=20))] + [([4, 5, 6], dict(max_new_tokens=3))] * 3
    eng, got, want = granite.serve(subs, jax_too=True)
    assert got == want
    assert len(got) == 4 and len(got[1]) == 20
    # prefill emits each request's 1st token, the ticks the rest: (20-1) + 3*(3-1)
    assert eng.tokens_generated == 19 + 3 * 2
    assert eng.ticks <= 20  # batched + refilled, not sequential (would be ~25)


def test_per_slot_positions_are_isolated(granite):
    """Different prompt lengths per slot must not cross-contaminate."""
    pa, pb = [3, 1, 4, 1, 5, 9, 2, 6], [2, 7]
    _, got, _ = granite.serve([(pa, dict(max_new_tokens=4)), (pb, dict(max_new_tokens=4))])
    assert got[1] == granite.reference(pa, 4)[0]
    assert got[2] == granite.reference(pb, 4)[0]


def test_eos_stops_early(granite):
    ref = granite.reference([5, 7, 11], 8)[0]
    eos = ref[2]  # force an early stop at the 3rd generated token
    _, got, _ = granite.serve([([5, 7, 11], dict(max_new_tokens=8, eos_id=eos))],
                              spec=dict(num_slots=1, max_len=64))
    assert got[1] == ref[:3]


def test_rwkv_family_serving():
    rwkv = Model("rwkv6-7b", dtype="float32")
    subs = [([1, 2, 3, 4], dict(max_new_tokens=4)), ([5, 6], dict(max_new_tokens=4))]
    _, got, want = rwkv.serve(subs, spec=dict(num_slots=2, max_len=32), jax_too=True)
    assert len(got) == 2 and all(len(o) == 4 for o in got.values())
    assert got == want


@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_mla_and_moe_engines_match_the_reference_engine(arch, monkeypatch):
    """The pooled engine's tokens equal the reference engine's (fp32), 8
    requests over 4 slots.  Both MoE smoke routers (qwen2-moe: 6 experts,
    granite-moe: 8, top 2 each) have a decode capacity of 2 at 4 slots
    (max(int(4 * 2 / E * 1.25), 2)), under the 8 assignments a tick makes,
    so pooled decode drops assignments, idle slots' stale tokens included,
    as the reference's does: the drop case, seen here by the port's
    routing."""
    _engines_match(Model(arch, dtype="float32"), monkeypatch)


@pytest.mark.parametrize("layers_", [8, 16], ids=["one_block", "stacked"])
def test_hybrid_engine_matches_the_reference_engine(layers_, monkeypatch):
    """jamba-v0.1-52b's smoke config (one block of 8 layers, and two
    stacked blocks: the engine writes each admitted slot's Mamba state at
    axis 1 of the stacked leaves), as the MLA and MoE engines: the same
    tokens as the reference's engine in fp32, 8 requests over 4 slots; its
    router (4 experts, top 2) has a decode capacity of 2 and drops."""
    _engines_match(Model("jamba-v0.1-52b", dtype="float32", num_layers=layers_), monkeypatch)


def _engines_match(model, monkeypatch):
    drops = []
    real = moe._router_assignments

    def spy(p, xg, m, capacity):
        out = real(p, xg, m, capacity)
        if xg.shape[:2] == (1, 4):  # a pooled decode: one group of the 4 slots
            drops.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(moe, "_router_assignments", spy)
    rng = np.random.default_rng(5)
    subs = [(rng.integers(1, model.cfg.vocab_size, size=int(rng.integers(2, 9))).tolist(),
             dict(max_new_tokens=int(rng.integers(3, 9)))) for _ in range(8)]
    eng, got, want = model.serve(subs, spec=dict(num_slots=4, max_len=32), jax_too=True)
    assert len(got) == 8 and got == want
    assert eng.tokens_generated == sum(kw["max_new_tokens"] - 1 for _, kw in subs)
    assert (sum(drops) > 0) == (model.cfg.moe is not None)


class Whisper:
    """The whisper-large-v3 smoke model (fp32) in both packages from the
    reference's weights."""

    def __init__(self, **kw):
        self.jcfg = dataclasses.replace(jax_get_arch("whisper-large-v3", smoke=True),
                                        dtype="float32", **kw)
        self.cfg = dataclasses.replace(get_arch("whisper-large-v3", smoke=True),
                                       dtype="float32", **kw)
        self.jparams = jE.init_encdec(jax.random.PRNGKey(0), self.jcfg)
        self.params = lm_params_from_jax(jax.device_get(self.jparams), "cpu",
                                         requires_grad=False)


@pytest.mark.parametrize("layers_", [None, 4], ids=["smoke", "slots_equal_layers"])
def test_encdec_engine_matches_the_reference_one_slot_engine(layers_):
    """8 requests over 4 slots (and, at 4 decoder layers, as many slots as
    layers: the engine finds the batch axis of every (L, B, ...) leaf
    there too) against the reference's engine at one slot, the only size
    it serves (its ``decode_step`` fails at a (B,) position of more than
    one row): each request's tokens equal, from zero frames (the
    frontend stub)."""
    w = Whisper(**({} if layers_ is None else dict(num_layers=layers_)))
    rng = np.random.default_rng(6)
    subs = [(rng.integers(1, w.cfg.vocab_size, size=int(rng.integers(2, 9))).tolist(),
             int(rng.integers(3, 9))) for _ in range(8)]
    eng = ServeEngine(w.cfg, w.params, spec=ServeSpec(num_slots=4, max_len=32), device="cpu")
    jeng = JaxServeEngine(w.jcfg, w.jparams, spec=JaxServeSpec(num_slots=1, max_len=32))
    for prompt, n in subs:
        eng.submit(prompt, max_new_tokens=n)
        jeng.submit(prompt, max_new_tokens=n)
    got = {r.uid: r.output for r in eng.run_until_drained()}
    want = {r.uid: r.output for r in jeng.run_until_drained()}
    assert len(got) == 8 and got == want
    assert eng.tokens_generated == sum(n - 1 for _, n in subs)
    assert eng.ticks < jeng.ticks
    assert tuple(eng.cache["cross_k"].shape) == (w.cfg.num_layers, 4, w.cfg.encoder_seq_len,
                                                 4, 16)


def test_reference_encdec_decode_fails_per_slot_where_the_port_serves():
    """The reference's fault, not copied: its ``encdec.decode_step`` at a
    (2,) position (the engine's per-slot positions at 2 slots) fails to
    broadcast the position against the frequencies in
    ``sinusoidal_embedding_at``; the port's decodes each row at its own
    position, as its batch-1 decode does."""
    w = Whisper()
    B, P = 2, 5
    toks = np.random.default_rng(2).integers(1, w.cfg.vocab_size, (B, P)).astype(np.int32)
    frames = np.zeros((B, w.cfg.encoder_seq_len, w.cfg.d_model), np.float32)
    _, jcache = jE.prefill(w.jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                           w.jcfg, jE.init_dec_cache(w.jcfg, B, 16))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jE.decode_step(w.jparams, jcache, jnp.asarray(toks[:, -1:]), jnp.asarray([P, P - 2]),
                       w.jcfg)
    tb = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    _, cache = encdec.prefill(w.params, tb, w.cfg, encdec.init_dec_cache(w.cfg, B, 16, "cpu"))
    logits, _ = encdec.decode_step(w.params, cache, tb["tokens"][:, -1:], np.array([P, P - 2]),
                                   w.cfg)
    for r, pos in enumerate((P, P - 2)):
        one = {k: v[r:r + 1, :pos] if k == "tokens" else v[r:r + 1] for k, v in tb.items()}
        _, c1 = encdec.prefill(w.params, one, w.cfg, encdec.init_dec_cache(w.cfg, 1, 16, "cpu"))
        want, _ = encdec.decode_step(w.params, c1, tb["tokens"][r:r + 1, -1:], pos, w.cfg)
        np.testing.assert_allclose(logits[r].numpy(), want[0].numpy(), rtol=0, atol=1e-5)


def test_engine_takes_no_flat_sizing_kwargs(granite):
    """Not a twin of ``test_flat_sizing_kwargs_warn_once_and_match_spec``: the
    port leaves the reference's warn-once ``num_slots=``/``max_len=`` shim out
    by decision (a new package has no callers to migrate), so the flat
    kwargs are refused and sizing comes from ``ServeSpec`` alone."""
    with pytest.raises(TypeError):
        ServeEngine(granite.cfg, granite.params, num_slots=2, device="cpu")
    with pytest.raises(TypeError):
        ServeEngine(granite.cfg, granite.params, max_len=32, device="cpu")
    eng = ServeEngine(granite.cfg, granite.params, spec=ServeSpec(num_slots=2, max_len=32),
                      device="cpu")
    assert (eng.num_slots, eng.max_len) == (2, 32)
    # the engine reads the first two fields; the rest are the read path's
    # (repro_torch.serve.readpath), the reference's names and defaults
    names = [f.name for f in dataclasses.fields(ServeSpec)]
    assert names[:2] == ["num_slots", "max_len"]
    assert names == [f.name for f in dataclasses.fields(JaxServeSpec)]
    assert ServeSpec() == ServeSpec(**{n: getattr(JaxServeSpec(), n) for n in names
                                       if n != "autotune"})


# ---------------------------------------------------------------------------
# bf16, the smoke config's own dtype: within the stated tolerance
# ---------------------------------------------------------------------------


def test_bf16_engine_follows_the_reference_within_tolerance():
    model = Model("granite-8b")
    prompts = [[5, 7, 11], [1, 2, 3], [9, 9, 9], [3, 1, 4, 1, 5, 9, 2, 6], [2, 7]]
    _, got, _ = model.serve([(p, dict(max_new_tokens=8)) for p in prompts])
    for uid, p in zip(sorted(got), prompts):
        tokens = got[uid]
        _, want = model.reference(p, len(tokens), forced=tokens)
        np.testing.assert_allclose(model.port_forced(p, tokens), want, rtol=0, atol=TOL_BF16)
        gaps = want.max(-1) - want[np.arange(len(tokens)), tokens]
        assert gaps.max() <= TOL_BF16, (uid, gaps)


# ---------------------------------------------------------------------------
# samplers, init, launcher
# ---------------------------------------------------------------------------


def test_samplers():
    logits = np.array([[1.0, 3.0, 3.0, 2.0], [0.5, 0.5, 0.1, 0.5], [-1, -2, -3, -1]],
                      np.float32)
    got = greedy_sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(jnp.argmax(jnp.asarray(logits), -1)).tolist() == [1, 0, 0]
    big = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 50)).astype(np.float32))
    draws = [temperature_sample(big, torch.Generator().manual_seed(7), 0.7) for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.int32
    assert torch.equal(temperature_sample(big * 1e4, torch.Generator().manual_seed(1)),
                       greedy_sample(big))


def test_init_lm_fills_stacked_leaves_with_the_same_values():
    """``init_lm`` fills each stacked leaf block by block; the values are
    those of drawing every block, then stacking (the former way)."""
    cfg = get_arch("granite-8b", smoke=True)
    got = transformer.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")

    gen = torch.Generator().manual_seed(3)
    want = {"embed": transformer.init_embedding(gen, cfg)}
    blocks = [{"sub0": transformer._init_sublayer(gen, cfg, ("attn", "mlp"))}
              for _ in range(cfg.num_layers)]
    stack = lambda ts: {k: stack([t[k] for t in ts]) for k in ts[0]} \
        if isinstance(ts[0], dict) else torch.stack(ts)  # noqa: E731
    want["blocks"] = stack(blocks)
    want["final_norm"] = transformer.init_norm(cfg, "cpu")
    want["lm_head"] = transformer.init_lm_head(gen, cfg)
    got, want = flatten(got), flatten(want)
    assert list(got) == list(want)
    for path in want:
        assert torch.equal(got[path], want[path]), path


def test_launcher_flags_are_the_reference_defaults(monkeypatch):
    """The reference parses inside ``main``: catch its namespace there."""
    seen = {}
    real = jax_launch.argparse.ArgumentParser.parse_args

    class Parsed(Exception):
        pass

    def catch(self, args=None, namespace=None):
        seen.update(vars(real(self, [], namespace)))
        raise Parsed

    monkeypatch.setattr(jax_launch.argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Parsed):
        jax_launch.main()
    monkeypatch.undo()
    got = vars(launch.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == seen
    assert launch.parse_args(["--full"]).smoke is False


def test_launcher_serves_on_the_cpu_and_raises_without_a_card(capsys, monkeypatch):
    rep = launch.run(["--device", "cpu", "--requests", "4", "--slots", "2", "--max-new", "5",
                      "--prompt-len", "6"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=granite-8b-smoke slots=2 requests=4")
    assert lines[1].startswith("throughput: ") and lines[2].startswith("ttft   p50=")
    assert lines[3].startswith("total  p50=")
    assert len(rep.done) == 4 and all(len(r.output) == 5 for r in rep.done)
    assert rep.engine.tokens_generated == 4 * (5 - 1)
    assert launch.main(["--device", "cpu", "--requests", "2", "--max-new", "2"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch.main(["--requests", "2"])


def test_launcher_serves_whisper_with_no_new_flag(capsys):
    """``--arch whisper-large-v3`` through the same launcher and engine:
    zero frames a request (the frontend stub), every request served at the
    launcher's slots."""
    rep = launch.run(["--device", "cpu", "--arch", "whisper-large-v3", "--requests", "6",
                      "--slots", "4", "--max-new", "4", "--prompt-len", "6"])
    assert capsys.readouterr().out.startswith("arch=whisper-large-v3-smoke slots=4 requests=6")
    assert rep.cfg.family == "encdec" and rep.engine.num_slots == 4
    assert len(rep.done) == 6 and all(len(r.output) == 4 for r in rep.done)
    assert rep.engine.tokens_generated == 6 * (4 - 1)
