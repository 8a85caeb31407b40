"""The slices end to end: the port's launcher (``repro_torch.launch.train``) on
the CPU at smoke size, ResNet-18 and the granite-8b LM, each against the JAX
trainer on the same synthetic store, loader settings, seed and initial
weights."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.config import LoaderConfig as JaxLoaderConfig  # noqa: E402
from repro.config import StoreConfig as JaxStoreConfig  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import replace as jax_replace  # noqa: E402
from repro.core.loader import ConcurrentDataLoader as JaxLoader  # noqa: E402
from repro.data.dataset import ImageDataset as JaxImageDataset  # noqa: E402
from repro.data.imagenet_synth import build_synthetic_imagenet as jax_build  # noqa: E402
from repro.data.store import build_store as jax_build_store  # noqa: E402
from repro.kernels.ingest_norm.ops import make_ingest_fn as jax_make_ingest_fn  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.steps import make_resnet_train_step as jax_make_step  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.config import register_arch, replace  # noqa: E402
from repro_torch.configs import resnet18_imagenet  # noqa: E402
from repro_torch.convert import resnet_state_from_jax, resnet_to_jax  # noqa: E402
from repro_torch.core.tracing import BATCH_TO_DEVICE, RUN_TRAINING_BATCH  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.resnet import init_resnet  # noqa: E402
from repro_torch.train.optim import make_optimizer  # noqa: E402

# The smoke config's 10 classes read synthetic ImageNet's labels (0..999) as
# NaN in both packages; with 1000 classes the loss is finite and comparable.
ARCH = "resnet18-imagenet-1k-classes"
ITEMS, BS, STEPS, LR = 16, 4, 6, 0.05  # 4 batches an epoch: the run crosses one
ARGS = ["--arch", ARCH, "--device", "cpu", "--items", str(ITEMS), "--batch-size", str(BS),
        "--steps", str(STEPS), "--latency", "0.001", "--avg-kb", "8", "--device-ingest",
        "--optimizer", "sgd", "--lr", str(LR), "--workers", "2", "--fetchers", "2"]


def test_launcher_matches_jax_trainer(monkeypatch):
    register_arch(ARCH, resnet18_imagenet.full,
                  lambda: replace(resnet18_imagenet.smoke(), num_classes=1000))
    jcfg = jax_replace(jax_get_arch("resnet18-imagenet", smoke=True), num_classes=1000)
    jt = JaxTrainConfig(optimizer="sgd", learning_rate=LR, total_steps=STEPS)
    # one set of weights, made from a seed, in the reference's layout (HWIO)
    np_params, np_bn = (resnet_to_jax(t) for t in init_resnet(
        launch.get_arch(ARCH, smoke=True), torch.Generator().manual_seed(0), "cpu"))
    jstate = {"params": np_params, "bn": np_bn,
              "opt": joptim.make_optimizer(jt).init(np_params), "step": jnp.zeros((), jnp.int32)}

    def converted_init(cfg, tcfg, generator, device):
        params, bn = resnet_state_from_jax(np_params, np_bn, device)
        return {"params": params, "bn": bn, "opt": make_optimizer(tcfg).init(params),
                "step": 0}

    monkeypatch.setattr(launch, "init_resnet_train_state", converted_init)
    report = launch.run(ARGS)

    store = jax_build_store(JaxStoreConfig(kind="s3sim", latency_mean_s=0.001),
                            base=jax_build(num_items=ITEMS, avg_kb=8.0))
    dataset = JaxImageDataset(store, ITEMS, out_size=jcfg.image_size,
                              sim_decode_s_per_mb=0.052, epilogue="device")
    loader = JaxLoader(dataset, JaxLoaderConfig(impl="threaded", batch_size=BS, num_workers=2,
                                                num_fetch_workers=2, seed=0))
    want = JaxTrainer(jax_make_step(jcfg, jt), jstate, ingest_fn=jax_make_ingest_fn()).fit(
        loader, epochs=100, max_steps=STEPS)

    got = report.result
    assert got.steps == want.steps == STEPS and got.epochs == want.epochs == 2
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in got.history], [h[k] for h in want.history],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert all(np.isfinite(h["loss"]) for h in got.history)
    # Table-3 columns come out of the same tracer
    assert len(report.tracer.spans(RUN_TRAINING_BATCH)) == STEPS
    assert report.batches_transferred == len(report.tracer.spans(BATCH_TO_DEVICE)) >= STEPS
    assert 0.0 < report.util.busy_fraction <= 1.0


def test_pipeline_launcher_matches_legacy_loss_stream():
    """``--pipeline --staging-buffers 2``: the staged pipeline with pinned
    staging (plain page-aligned buffers here) feeds the same batches, in the
    same order, as the legacy loader, so the loss stream is the same."""
    register_arch(ARCH, resnet18_imagenet.full,
                  lambda: replace(resnet18_imagenet.smoke(), num_classes=1000))
    legacy = launch.run(ARGS)
    staged = launch.run(ARGS + ["--pipeline", "--staging-buffers", "2", "--cpu-workers", "2"])
    assert legacy.stages == []
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_array_equal([h[k] for h in staged.result.history],
                                      [h[k] for h in legacy.result.history], err_msg=k)
    assert staged.result.steps == STEPS and staged.result.epochs == 2
    # one snapshot an epoch, each of its own iterator and staging pool
    assert len(staged.stages) == 2
    for st in staged.stages:
        assert st["reorder"] == "strict" and st["cpu_executor"] == "thread"
        assert st["staging"]["leases"] == st["emitted_batches"] >= 2
    # epoch 0 ran to its end: every lease went through the ring's release,
    # and on the CPU each one aliased its buffers.  Epoch 1 was cut at
    # max_steps, when the ring may hold one batch it pulled but never sent.
    first, cut = (st["staging"] for st in staged.stages)
    assert first["detached"] == first["leases"] == 4
    assert cut["leases"] - 1 <= cut["detached"] <= cut["leases"]
    assert first["leases"] + cut["detached"] == staged.batches_transferred >= STEPS


# the launcher's pipeline flags, by the PipelineConfig field each one sets
PIPELINE_FLAGS = {"pipeline": "enabled", "reorder": "reorder", "reorder_window": "reorder_window",
                  "io_workers": "io_workers", "cpu_workers": "cpu_workers",
                  "cpu_executor": "cpu_executor", "staging_buffers": "staging_buffers"}


def test_pipeline_flags_take_the_reference_defaults():
    """The reference's launcher defaults each pipeline flag to its
    PipelineConfig field's default; so does the port's."""
    from repro.config import PipelineConfig as JaxPipelineConfig

    args = vars(launch.parse_args([]))
    ref = JaxPipelineConfig()
    assert {f: args[a] for a, f in PIPELINE_FLAGS.items()} == {
        f: getattr(ref, f) for f in PIPELINE_FLAGS.values()}


class _Parsed(Exception):
    """Carries the ArgumentParser a launcher's ``main`` built."""

    def __init__(self, parser):
        super().__init__("parser built")
        self.parser = parser


def _flags(parser):
    """Each option flag of ``parser``: its default and choices."""
    return {a.option_strings[0]: (a.default, None if a.choices is None else list(a.choices))
            for a in parser._actions if a.option_strings and a.dest != "help"}


def _reference_parser(monkeypatch, main):
    import argparse

    def capture(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as parsed:
        main()
    monkeypatch.undo()
    return parsed.value.parser


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_shared_flags_take_the_reference_defaults_and_choices(monkeypatch, launcher):
    """Every flag both launchers have takes the reference's default and
    choices, for training and serving: ``--arch`` defaults to granite-8b in
    both (pass ``--arch resnet18-imagenet`` for the paper's ResNet),
    ``--cache-mb`` to 0, and ``--optimizer`` takes any name, as the
    reference's does (an unknown one raises in ``make_optimizer``)."""
    import importlib

    port_mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    ref_mod = importlib.import_module(f"repro.launch.{launcher}")
    ref = _flags(_reference_parser(monkeypatch, ref_mod.main))
    port = _flags(_reference_parser(monkeypatch, lambda: port_mod.parse_args([])))
    shared = sorted(set(ref) & set(port))
    assert {f: port[f] for f in shared} == {f: ref[f] for f in shared}
    assert "--arch" in shared and port["--arch"][0] == "granite-8b"
    assert launch.parse_args([]).arch == "granite-8b"
    if launcher == "train":
        assert {"--cache-mb", "--optimizer", "--store", "--pipeline"} <= set(shared)
        # the reference's flags the port lacks come with later items
        assert set(ref) - set(port) == {"--transport", "--delivery", "--delivery-axis",
                                        "--ckpt-dir", "--ckpt-every", "--resume"}
    else:
        assert set(ref) <= set(port)


@pytest.mark.parametrize("flags", [
    ["--pipeline", "--transport", "shm"],
    ["--delivery", "sharded"],
    ["--delivery-axis=data"],
])
def test_unported_launcher_flags_are_unknown(flags):
    """The reference's flags for features the port lacks are not added just
    to raise: argparse refuses them as unknown arguments."""
    with pytest.raises(SystemExit):
        launch.parse_args(ARGS + flags)


class _Built(Exception):
    """Carries the LoaderConfig a launcher handed to make_loader."""

    def __init__(self, cfg):
        super().__init__("loader config built")
        self.cfg = cfg


def _loader_config(monkeypatch, module, call):
    def capture(cfg, dataset, **kw):
        raise _Built(cfg)

    monkeypatch.setattr(module, "make_loader", capture)
    with pytest.raises(_Built) as built:
        call()
    return built.value.cfg


@pytest.mark.parametrize("flags", [["--hedge"], ["--autotune"], ["--thread-budget", "4"],
                                   ["--cache-mb", "4"]])
def test_launcher_flags_build_the_reference_loader_config(monkeypatch, flags):
    """``--hedge``, ``--autotune``, ``--thread-budget N`` and ``--cache-mb N``
    reach the loader and the store as the reference's launcher passes them:
    ``hedge_requests``, an ``AutotuneConfig`` enabled by either autotune
    flag, with the budget, and a ``StoreConfig`` whose ``CacheConfig`` holds
    an N MiB memory tier (no tracer handed to the store, in either)."""
    import sys

    from repro.launch import train as jax_launch

    stores = {}

    def recording(module, side):
        real = module.build_store

        def build(cfg, *a, **kw):
            stores.setdefault(side, []).append((cfg, kw.get("tracer")))
            return real(cfg, *a, **kw)

        monkeypatch.setattr(module, "build_store", build)

    recording(launch, "port")
    recording(jax_launch, "reference")
    argv = ["--arch", "resnet18-imagenet", "--items", "8", "--batch-size", "4",
            "--store", "memory", "--pipeline", "--workers", "2", "--fetchers", "2"] + flags
    port = _loader_config(monkeypatch, launch,
                          lambda: launch.run(argv + ["--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    ref = _loader_config(monkeypatch, jax_launch, jax_launch.main)
    (pstore, ptracer), = stores["port"]
    (rstore, rtracer), = stores["reference"]
    assert ptracer is None and rtracer is None
    assert dataclasses.asdict(pstore) == dataclasses.asdict(rstore)
    assert pstore.cache.memory_bytes == (4 << 20 if flags[0] == "--cache-mb" else 0)
    fields = ("impl", "batch_size", "num_workers", "num_fetch_workers", "seed",
              "hedge_requests", "hedge_factor", "hedge_min_s")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    ported = [f.name for f in dataclasses.fields(port.autotune)]
    assert {f: getattr(port.autotune, f) for f in ported} == {
        f: getattr(ref.autotune, f) for f in ported}
    assert port.pipeline.enabled and ref.pipeline.enabled
    assert port.hedge_requests is (flags[0] == "--hedge")
    assert port.autotune.enabled is (flags[0] in ("--autotune", "--thread-budget"))
    assert port.autotune.thread_budget == (4 if flags[0] == "--thread-budget" else 0)
    assert launch.parse_args(argv).hedge is (flags[0] == "--hedge")


def test_hedged_run_gives_the_unhedged_loss_stream():
    """``--hedge`` (duplicate straggling GETs, first response wins) feeds the
    same batches in the same order, so the loss stream is the same."""
    register_arch(ARCH, resnet18_imagenet.full,
                  lambda: replace(resnet18_imagenet.smoke(), num_classes=1000))
    plain = launch.run(ARGS)
    hedged = launch.run(ARGS + ["--hedge"])
    assert hedged.loader.hedge is not None and plain.loader.hedge is None
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_array_equal([h[k] for h in hedged.result.history],
                                      [h[k] for h in plain.result.history], err_msg=k)
    assert all(np.isfinite(h["loss"]) for h in hedged.result.history)


def test_autotuned_pipeline_run_gives_the_fixed_loss_stream():
    """``--pipeline --autotune`` moves the pipeline's knobs between batches
    (strict reorder), and ``--thread-budget`` its io/cpu split: the loss
    stream is the fixed-knob pipeline's."""
    register_arch(ARCH, resnet18_imagenet.full,
                  lambda: replace(resnet18_imagenet.smoke(), num_classes=1000))
    pipe_args = ARGS + ["--pipeline", "--staging-buffers", "2", "--cpu-workers", "2"]
    fixed = launch.run(pipe_args)
    assert fixed.loader.autotuner is None and fixed.tuned == [{}, {}]
    for flags in (["--autotune"], ["--thread-budget", "6"]):
        tuned = launch.run(pipe_args + flags)
        for k in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_array_equal([h[k] for h in tuned.result.history],
                                          [h[k] for h in fixed.result.history], err_msg=k)
        auto = tuned.loader.autotuner
        assert auto is not None and len(tuned.tuned) == 2
        knobs = {k.name for k in auto.knobs}
        assert "device_prefetch" in knobs and auto.util_fn is not None
        if flags[0] == "--thread-budget":
            assert "io_cpu_split" in knobs
            assert all(st["io_workers"] + st["cpu_workers"] == 6 for st in tuned.stages)
        else:
            assert {"io_workers", "cpu_workers"} <= knobs


LM_ARCH = "granite-8b-f32"
LM_ITEMS, LM_BS, LM_SEQ, LM_STEPS = 12, 4, 32, 4  # 3 batches an epoch: the run crosses one
LM_ARGS = ["--arch", LM_ARCH, "--device", "cpu", "--items", str(LM_ITEMS),
           "--batch-size", str(LM_BS), "--seq-len", str(LM_SEQ), "--steps", str(LM_STEPS),
           "--latency", "0.001", "--optimizer", "adamw", "--lr", "1e-3", "--microbatches", "2",
           "--workers", "2", "--fetchers", "2"]


def test_lm_launcher_matches_jax_trainer(monkeypatch):
    """``--arch granite-8b`` trains the smoke decoder from packed token
    sequences behind simulated S3, two microbatches a step, in fp32 so the
    histories compare at 1e-4."""
    import jax

    import repro.models.transformer as jT
    from repro.data.dataset import TokenDataset as JaxTokenDataset
    from repro.data.dataset import build_token_store as jax_build_tokens
    from repro.data.store import InMemoryStore as JaxInMemoryStore
    from repro.train.steps import make_train_step as jax_make_train_step
    from repro_torch.configs import granite_8b
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.train.steps import lm_train_state

    register_arch(LM_ARCH, granite_8b.full,
                  lambda: replace(granite_8b.smoke(), dtype="float32"))
    jcfg = jax_replace(jax_get_arch("granite-8b", smoke=True), dtype="float32")
    jt = JaxTrainConfig(optimizer="adamw", learning_rate=1e-3, microbatches=2,
                        total_steps=LM_STEPS)
    np_params = jax.device_get(jT.init_lm(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(launch, "init_train_state", lambda cfg, tcfg, generator, device:
                        lm_train_state(lm_params_from_jax(np_params, device), tcfg))
    report = launch.run(LM_ARGS)

    base = JaxInMemoryStore()
    jax_build_tokens(base, LM_ITEMS, LM_SEQ, jcfg.vocab_size)
    store = jax_build_store(JaxStoreConfig(kind="s3sim", latency_mean_s=0.001), base=base)
    loader = JaxLoader(JaxTokenDataset(store, LM_ITEMS, LM_SEQ),
                       JaxLoaderConfig(impl="threaded", batch_size=LM_BS, num_workers=2,
                                       num_fetch_workers=2, seed=0))
    jstate = {"params": np_params, "opt": joptim.make_optimizer(jt).init(np_params),
              "step": jnp.zeros((), jnp.int32)}
    want = JaxTrainer(jax_make_train_step(jcfg, jt), jstate).fit(
        loader, epochs=100, max_steps=LM_STEPS)

    got = report.result
    assert got.steps == want.steps == LM_STEPS and got.epochs == want.epochs == 2
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in got.history], [h[k] for h in want.history],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert all(np.isfinite(h["loss"]) for h in got.history)
    assert len(report.tracer.spans(RUN_TRAINING_BATCH)) == LM_STEPS
    with pytest.raises(SystemExit, match="device-ingest"):
        launch.run(LM_ARGS + ["--device-ingest"])
