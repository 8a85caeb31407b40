"""Optimizers and the ResNet train step in the port against the JAX reference:
three steps each of SGD, AdamW and Adafactor from the same weights, handed to
the port through ``convert`` (Adafactor factors each OIHW conv weight as the
reference factors its HWIO one, through ``optim.hwio_view``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.steps import make_resnet_train_step as jax_make_step  # noqa: E402
from repro_torch.config import TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import resnet_state_from_jax, resnet_to_jax  # noqa: E402
from repro_torch.models.resnet import init_resnet  # noqa: E402
from repro_torch.train.optim import hwio_view, make_optimizer, make_schedule  # noqa: E402
from repro_torch.train.steps import init_resnet_train_state, make_resnet_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, raw_train_loop  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# lr large enough and warm-up short enough that three steps move the weights;
# grad_clip below the smoke model's gradient norm so clipping is exercised
HPARAMS = dict(learning_rate=0.05, warmup_steps=2, total_steps=6, grad_clip=0.5,
               weight_decay=1e-2)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    kw = dict(learning_rate=0.1, warmup_steps=3, total_steps=10, schedule=schedule)
    want = joptim.make_schedule(JaxTrainConfig(**kw))
    got = make_schedule(TrainConfig(**kw))
    for step in range(12):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw", "adafactor"])
def test_three_steps_match_jax(optimizer):
    jcfg = jax_get_arch("resnet18-imagenet", smoke=True)
    cfg = get_arch("resnet18-imagenet", smoke=True)
    jt = JaxTrainConfig(optimizer=optimizer, **HPARAMS)
    tcfg = TrainConfig(optimizer=optimizer, **HPARAMS)
    # one set of weights, made from a seed, in the reference's layout (HWIO)
    np_params, np_bn = (resnet_to_jax(t) for t in init_resnet(cfg, torch.Generator().manual_seed(0),
                                                       "cpu"))
    jstate = {"params": np_params, "bn": np_bn,
              "opt": joptim.make_optimizer(jt).init(np_params), "step": jnp.zeros((), jnp.int32)}
    params, bn = resnet_state_from_jax(np_params, np_bn, "cpu")
    state = {"params": params, "bn": bn, "opt": make_optimizer(tcfg, view=hwio_view).init(params),
             "step": 0}

    rng = np.random.default_rng(3)
    image = rng.standard_normal((4, 3, 32, 32), dtype=np.float32)
    label = rng.integers(0, cfg.num_classes, 4).astype(np.int32)
    jbatch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    batch = {"image": torch.from_numpy(image), "label": torch.from_numpy(label)}

    jstep = jax.jit(jax_make_step(jcfg, jt))
    step = make_resnet_train_step(cfg, tcfg)
    clipped = False
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        for k in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), err_msg=k, **TOL)
        clipped |= float(jm["grad_norm"]) > HPARAMS["grad_clip"]
    assert clipped and state["step"] == 3
    for name in ("params", "bn", "opt"):
        got, want = flatten(resnet_to_jax(state[name])), flatten(jax.device_get(jstate[name]))
        assert list(got) == list(want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], err_msg=f"{name}/{path}", **TOL)


def test_trainer_and_raw_loop_agree():
    """Same init, same batches: the hooked Trainer and the raw loop produce
    the same history, and the Trainer's state carries the updated weights."""
    cfg = get_arch("resnet18-imagenet", smoke=True)
    tcfg = TrainConfig(optimizer="sgd", **HPARAMS)
    rng = np.random.default_rng(5)
    batches = [{"image": rng.standard_normal((4, 3, 32, 32), dtype=np.float32),
                "label": rng.integers(0, cfg.num_classes, 4).astype(np.int32)}
               for _ in range(3)]

    def fresh():
        return init_resnet_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")

    seen = []

    class Spy:
        def on_train_batch_end(self, trainer, metrics, idx):
            seen.append(idx)

        def __getattr__(self, name):
            return lambda *a: None

    trainer = Trainer(make_resnet_train_step(cfg, tcfg), fresh(), callbacks=[Spy()],
                      device="cpu")
    res = trainer.fit(batches, epochs=1)
    raw = raw_train_loop(make_resnet_train_step(cfg, tcfg), fresh(), batches, device="cpu")
    assert res.steps == raw.steps == 3 and seen == [0, 1, 2]
    for a, b in zip(res.history, raw.history):
        assert a == pytest.approx(b, rel=1e-6)
    assert trainer.state["step"] == 3


def _lm_run(tracer):
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = get_arch("granite-8b", smoke=True)
    tcfg = TrainConfig(microbatches=2, **HPARAMS)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()})
    return Trainer(make_train_step(cfg, tcfg), state, tracer=tracer, device="cpu").fit(batches)


def _resnet_run(tracer):
    cfg = get_arch("resnet18-imagenet", smoke=True)
    tcfg = TrainConfig(optimizer="sgd", **HPARAMS)
    rng = np.random.default_rng(5)
    batches = [{"image": rng.standard_normal((4, 3, 32, 32), dtype=np.float32),
                "label": rng.integers(0, cfg.num_classes, 4).astype(np.int32)}
               for _ in range(3)]
    state = init_resnet_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    return Trainer(make_resnet_train_step(cfg, tcfg), state, tracer=tracer,
                   device="cpu").fit(batches)


@pytest.mark.parametrize("run, microbatches", [(_lm_run, 2), (_resnet_run, 1)],
                         ids=["lm", "resnet"])
def test_trainer_records_the_step_phases_in_order(run, microbatches):
    """Each step: one ring_wait before its run_training_batch; inside it, in
    order and apart, the microbatches' step_fwd_bwd (mb 0..M-1), one
    step_optimizer and one step_sync at its end, all tagged with the
    trainer's step.  The traced history equals the untraced one, bit for bit."""
    from repro_torch.core import tracing

    tr = tracing.Tracer()
    res = run(tr)
    assert res.history == run(tracing.NULL_TRACER).history
    steps = sorted(tr.spans(tracing.RUN_TRAINING_BATCH), key=lambda s: s.t0)
    waits = sorted(tr.spans(tracing.RING_WAIT), key=lambda s: s.t0)
    assert [s.args["step"] for s in steps] == [0, 1, 2]
    assert [w.args["handed"] for w in waits[:3]] == [0, 1, 2]
    inner = (tracing.STEP_FWD_BWD, tracing.STEP_GRAD_REDUCE, tracing.STEP_OPTIMIZER,
             tracing.STEP_SYNC)
    for i, rtb in enumerate(steps):
        before = [w for w in waits if w.t1 <= rtb.t0 and (i == 0 or w.t0 >= steps[i - 1].t1)]
        assert len(before) == 1
        got = sorted((s for s in tr.spans() if s.name in inner and s.args["step"] == i),
                     key=lambda s: s.t0)
        assert [(s.name, s.args.get("mb")) for s in got] == (
            [(tracing.STEP_FWD_BWD, m) for m in range(microbatches)]
            + [(tracing.STEP_OPTIMIZER, None), (tracing.STEP_SYNC, None)])
        assert rtb.t0 <= got[0].t0 and got[-1].t1 <= rtb.t1
        assert all(a.t1 <= b.t0 for a, b in zip(got, got[1:]))
