"""Checkpointing and fault tolerance in the port (``repro_torch.train.
checkpoint``, ``train.fault_tolerance``, ``CheckpointCallback`` and the
launcher's ``--ckpt-dir``/``--resume``) against the JAX reference: twins of
``tests/test_checkpoint_ft.py``, and checkpoint files read across packages
both ways (the granite-8b smoke LM with AdamW; the ResNet-18 smoke with its
BatchNorm state and HWIO conv leaves on disk)."""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.transformer as jT  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.train.checkpoint import _treedef_paths as jax_paths  # noqa: E402
from repro.train.steps import init_resnet_train_state as jax_init_resnet_state  # noqa: E402
from repro.train.steps import make_resnet_train_step as jax_make_resnet_step  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.config import LoaderConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    RESNET_LAYOUT,
    checkpoint_layout,
    lm_params_from_jax,
    resnet_to_jax,
    to_jax,
)
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.data.dataset import SyntheticTokenDataset  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.fault_tolerance import (  # noqa: E402
    HeartbeatMonitor,
    RestartPolicy,
    elastic_plan,
)
from repro_torch.train.steps import (  # noqa: E402
    init_resnet_train_state,
    init_train_state,
    lm_train_state,
    make_resnet_train_step,
    make_train_step,
)
from repro_torch.tree import flatten, leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # test_torch_train.py's and test_torch_resnet.py's


def tiny_state():
    cfg = get_arch("granite-8b", smoke=True)
    tcfg = TrainConfig(optimizer="adamw", warmup_steps=1)
    return cfg, tcfg, init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")


# --------------------------------------------------------------------------
# twins of tests/test_checkpoint_ft.py
# --------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    cfg, tcfg, state = tiny_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, state, extra_meta={"epoch": 0})
    restored, meta = mgr.restore(state)
    assert meta["step"] == 5 and meta["extra"]["epoch"] == 0
    for a, b in zip(leaves(state), leaves(restored)):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            assert a.requires_grad == b.requires_grad and a.device == b.device
        else:
            assert a == b and type(b) is int


def test_retention_gc(tmp_path):
    small = {"w": torch.ones(4)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, small)
    assert mgr.steps() == [3, 4]


def test_async_save(tmp_path):
    small = {"w": torch.arange(1024.0)}
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(7, small, blocking=False)
    mgr.wait()
    restored, meta = mgr.restore(small)
    assert meta["step"] == 7
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(1024.0))


def test_atomicity_no_partial_dirs(tmp_path):
    small = {"w": torch.ones(8)}
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, small)
    entries = os.listdir(tmp_path)
    assert entries == ["step_00000001"]  # no tmp residue


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.ones(5)})


def test_crash_restart_reproduces_training(tmp_path):
    """Train 6 steps straight vs train 3 + crash + restore + 3: identical."""
    cfg, tcfg, _ = tiny_state()
    ds = SyntheticTokenDataset(96, 16, cfg.vocab_size)
    lcfg = LoaderConfig(impl="threaded", batch_size=16, num_workers=2, seed=1)
    step = make_train_step(cfg, tcfg)

    def batch_of(b):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}

    # continuous run (the step updates in place: from a fresh init)
    _, _, state = tiny_state()
    dl = ConcurrentDataLoader(ds, lcfg)
    losses_cont = []
    for b in dl:
        state, m = step(state, batch_of(b))
        losses_cont.append(m["loss"].item())
    params_cont = [p.detach().clone() for p in leaves(state["params"])]

    # crash at step 3
    mgr = CheckpointManager(str(tmp_path))
    _, _, state = tiny_state()
    dl = ConcurrentDataLoader(ds, lcfg)
    it = iter(dl)
    for _ in range(3):
        state, m = step(state, batch_of(next(it)))
    mgr.save(3, state, extra_meta={"loader": dl.state_dict()})
    it.shutdown()
    del state

    # "new process": restore and resume
    _, _, template = tiny_state()
    restored, meta = mgr.restore(template)
    dl2 = ConcurrentDataLoader(ds, lcfg)
    dl2.load_state_dict(meta["extra"]["loader"])
    losses_resumed = []
    state = restored
    for b in dl2:
        state, m = step(state, batch_of(b))
        losses_resumed.append(m["loss"].item())
    assert losses_resumed == pytest.approx(losses_cont[3:], rel=1e-5)
    for a, b in zip(params_cont, leaves(state["params"])):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_heartbeat_monitor():
    hb = HeartbeatMonitor([0, 1, 2, 3], timeout_s=10.0)
    now = time.monotonic()
    hb.beat(0, now)
    hb.beat(1, now)
    hb.beat(2, now - 50)  # stale
    hb.beat(3, now)
    assert hb.dead(now) == [2]
    assert hb.alive(now) == [0, 1, 3]


def test_elastic_plan_covers_batch_exactly():
    batch = list(range(64))
    plan = elastic_plan(batch, [0, 1, 2, 3])
    got = sorted(sum(plan.values(), []))
    assert got == batch
    # hosts 1,2 die -> re-plan over survivors: still an exact disjoint cover
    plan2 = elastic_plan(batch, [0, 3])
    assert sorted(sum(plan2.values(), [])) == batch
    assert len(plan2[0]) == 32
    assert set(plan2[0]).isdisjoint(plan2[3])
    # non-divisible membership is rejected loudly, not silently dropped (the
    # port's shard_plan raises ValueError where the reference asserts)
    with pytest.raises(ValueError, match="divide"):
        elastic_plan(batch, [0, 1, 3])


def test_restart_policy_backoff():
    rp = RestartPolicy(max_restarts=2, backoff_s=1.0)
    assert rp.on_failure() == 1.0
    assert rp.on_failure() == 2.0
    with pytest.raises(RuntimeError):
        rp.on_failure()


# --------------------------------------------------------------------------
# checkpoint files across packages
# --------------------------------------------------------------------------


def _lm_setup():
    cfg = get_arch("granite-8b", smoke=True)
    jcfg = jax_get_arch("granite-8b", smoke=True)
    kw = dict(optimizer="adamw", warmup_steps=1, learning_rate=1e-2)
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32),
                "targets": rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)}
               for _ in range(2)]
    return cfg, jcfg, TrainConfig(**kw), JaxTrainConfig(**kw), np_params, batches


def _jax_lm_state(np_params, jt):
    params = jax.tree.map(jnp.asarray, np_params)
    return {"params": params, "opt": jax_make_optimizer(jt).init(params),
            "step": jnp.zeros((), jnp.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_jax_lm_checkpoint_restores_into_the_port(tmp_path):
    """The reference saves granite-8b smoke after one AdamW step (moments
    non-zero); the port restores it into its own template, leaf for leaf,
    and its next step gives the reference's next loss."""
    cfg, jcfg, tcfg, jt, np_params, batches = _lm_setup()
    jstep = jax.jit(jax_make_train_step(jcfg, jt))
    jstate, _ = jstep(_jax_lm_state(np_params, jt), batches[0])
    JaxCheckpointManager(str(tmp_path)).save(1, jstate, extra_meta={"loader": {"epoch": 0,
                                                                               "next_batch": 1}})

    template = lm_train_state(lm_params_from_jax(np_params, "cpu"), tcfg)
    mgr = CheckpointManager(str(tmp_path))
    state, meta = mgr.restore(template)
    assert meta == {"step": 1, "extra": {"loader": {"epoch": 0, "next_batch": 1}}}
    assert state["step"] == 1 and type(state["step"]) is int
    want = {k: np.asarray(v) for k, v in flatten(jax.device_get(jstate)).items()}
    got = flatten(state)
    assert set(got) == set(want)
    for path, t in got.items():
        if isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(t.detach().numpy(), want[path], err_msg=path)
    assert all(p.requires_grad for p in leaves(state["params"]))
    assert not any(t.requires_grad for t in leaves(state["opt"]))

    _, jm = jstep(jstate, batches[1])
    _, m = make_train_step(cfg, tcfg)(state, _torch_batch(batches[1]))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **TOL)


def _resnet_setup(optimizer="adamw"):
    cfg = get_arch("resnet18-imagenet", smoke=True)
    jcfg = jax_get_arch("resnet18-imagenet", smoke=True)
    kw = dict(optimizer=optimizer, warmup_steps=1, learning_rate=1e-2)
    rng = np.random.default_rng(3)
    batches = [{"image": rng.standard_normal((4, 3, 32, 32), dtype=np.float32),
                "label": rng.integers(0, cfg.num_classes, 4).astype(np.int32)}
               for _ in range(2)]
    return cfg, jcfg, TrainConfig(**kw), JaxTrainConfig(**kw), batches


def test_jax_resnet_checkpoint_restores_into_the_port(tmp_path):
    """ResNet-18 smoke with BatchNorm state and AdamW moments: the file holds
    HWIO conv weights and moments; the port restores them OIHW through
    RESNET_LAYOUT, and its next step gives the reference's loss."""
    cfg, jcfg, tcfg, jt, batches = _resnet_setup()
    jstep = jax.jit(jax_make_resnet_step(jcfg, jt))
    jstate, _ = jstep(jax_init_resnet_state(jcfg, jt, jax.random.PRNGKey(0)), batches[0])
    JaxCheckpointManager(str(tmp_path)).save(1, jstate)

    template = init_resnet_train_state(cfg, tcfg, torch.Generator().manual_seed(5), "cpu")
    assert checkpoint_layout(cfg) is RESNET_LAYOUT
    state, meta = CheckpointManager(str(tmp_path), layout=checkpoint_layout(cfg)).restore(template)
    assert meta["step"] == 1 and state["step"] == 1
    want = {k: np.asarray(v) for k, v in flatten(jax.device_get(jstate)).items()}
    got = flatten(resnet_to_jax({k: v for k, v in state.items() if k != "step"}))
    assert set(got) | {"step"} == set(want)
    n4 = 0
    for path, a in got.items():
        np.testing.assert_array_equal(a, want[path], err_msg=path)
        n4 += a.ndim == 4
    n_conv = sum(t.ndim == 4 for t in leaves(state["params"]))
    assert n_conv > 0 and n4 == 3 * n_conv  # conv weights and both moments of each
    assert flatten(state["params"])["stem/conv/w"].shape[:2] == (cfg.resnet_width, 3)  # OIHW

    _, jm = jstep(jstate, batches[1])
    _, m = make_resnet_train_step(cfg, tcfg)(state, _torch_batch(batches[1]))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **TOL)


@pytest.mark.parametrize("family", ["lm", "resnet", "resnet_adafactor"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, family):
    """A checkpoint the port writes (after one step, asynchronously) is read
    by the reference's CheckpointManager.restore: equal keys, shapes and
    values, the step a 0-d int32, the ResNet's convs HWIO (with Adafactor,
    their factored moments in the reference's shapes)."""
    if family == "lm":
        cfg, jcfg, tcfg, jt, np_params, batches = _lm_setup()
        state = lm_train_state(lm_params_from_jax(np_params, "cpu"), tcfg)
        state, _ = make_train_step(cfg, tcfg)(state, _torch_batch(batches[0]))
        jtemplate = _jax_lm_state(np_params, jt)
        expect = to_jax({k: v for k, v in state.items() if k != "step"})
    else:
        cfg, jcfg, tcfg, jt, batches = _resnet_setup(
            "adafactor" if family == "resnet_adafactor" else "adamw")
        state = init_resnet_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
        state, _ = make_resnet_train_step(cfg, tcfg)(state, _torch_batch(batches[0]))
        jtemplate = jax_init_resnet_state(jcfg, jt, jax.random.PRNGKey(0))
        expect = resnet_to_jax({k: v for k, v in state.items() if k != "step"})
    mgr = CheckpointManager(str(tmp_path), layout=checkpoint_layout(cfg))
    mgr.save(1, state, extra_meta={"loader": {"epoch": 0, "next_batch": 1}}, blocking=False)
    mgr.wait()
    with np.load(tmp_path / "step_00000001" / "arrays_h0.npz") as z:
        keys = set(z.files)
    assert keys == set(jax_paths(jtemplate))
    restored, meta = JaxCheckpointManager(str(tmp_path)).restore(jtemplate)
    assert meta == {"step": 1, "extra": {"loader": {"epoch": 0, "next_batch": 1}}}
    got = {k: np.asarray(v) for k, v in flatten(jax.device_get(restored)).items()}
    assert got["step"].dtype == np.int32 and got["step"].shape == () and got["step"] == 1
    for path, a in flatten(expect).items():
        assert got[path].shape == a.shape and got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path], a, err_msg=path)


def test_async_save_is_a_snapshot(tmp_path):
    """``save(blocking=False)`` copies every leaf before it returns: the
    state updated in place right after (as the next train step does, and as
    a CPU tensor's numpy view would show) does not reach the file."""
    cfg, tcfg, state = tiny_state()
    before = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
              for k, v in flatten(state).items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, blocking=False)
    with torch.no_grad():
        for t in leaves(state["params"]) + leaves(state["opt"]):
            t.add_(1.0)
    mgr.wait()
    _, _, template = tiny_state()
    restored, _ = mgr.restore(template)
    for path, t in flatten(restored).items():
        if isinstance(t, torch.Tensor):
            torch.testing.assert_close(t, before[path], rtol=0, atol=0, msg=path)
    # a second save reuses the snapshot buffers and sees the new values
    mgr.save(3, state, blocking=False)
    restored, _ = mgr.restore(template, step=3)
    p0 = leaves(state["params"])[0]
    torch.testing.assert_close(leaves(restored["params"])[0], p0.detach(), rtol=0, atol=0)
    assert mgr.last_bytes > 0 and mgr.last_write_s > 0


def test_failed_async_save_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    # a file where the writer's tmp directory must go: the write fails
    (tmp_path / f"step_00000001.tmp-{os.getpid()}").write_text("")
    mgr.save(1, {"w": torch.ones(2)}, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        mgr.wait()
    mgr.wait()  # the error is reported once


LM_ARGS = ["--arch", "granite-8b", "--device", "cpu", "--items", "16", "--batch-size", "4",
           "--seq-len", "64", "--steps", "8", "--latency", "0.001", "--workers", "2",
           "--fetchers", "2", "--log-every", "100"]


def test_launcher_resume_reproduces_the_unbroken_losses(tmp_path):
    """``--ckpt-dir D --ckpt-every 3`` then ``--resume`` from a directory
    whose newest complete step is 3 (step 6 lost, a torn ``.tmp-`` write
    left behind): the resumed steps 4-8 give the unbroken run's losses,
    across an epoch boundary (4 batches an epoch)."""
    unbroken = launch.run(LM_ARGS)
    want = [h["loss"] for h in unbroken.result.history]
    ckpt = tmp_path / "ckpt"
    first = launch.run(LM_ARGS + ["--ckpt-dir", str(ckpt), "--ckpt-every", "3"])
    assert [h["loss"] for h in first.result.history] == pytest.approx(want, rel=1e-5)
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000006"]
    import shutil

    shutil.rmtree(ckpt / "step_00000006")
    (ckpt / "step_00000007.tmp-12345").mkdir()  # a writer killed mid-write
    resumed = launch.run(LM_ARGS + ["--ckpt-dir", str(ckpt), "--ckpt-every", "3", "--resume"])
    assert resumed.resumed_from == 3 and resumed.result.steps == 8
    got = [h["loss"] for h in resumed.result.history]
    assert got == pytest.approx(want[3:], rel=1e-5)
    with np.load(ckpt / "step_00000006" / "arrays_h0.npz") as z:
        assert int(z["step"]) == 6


def test_restore_dtype_mismatch_raises(tmp_path):
    """The port also checks each leaf's dtype against the template's (the
    reference checks shapes only): a float64 file leaf never lands in a
    float32 parameter silently."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4, dtype=torch.float64)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore({"w": torch.ones(4)})
