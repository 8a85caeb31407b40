"""Data-parallel training in the port (``repro_torch.launch.dist``, the
process mesh, sharded delivery across ranks, the data-parallel steps, the
rank-0 checkpoint) against the JAX reference on a W-device mesh.

The reference's sides need ``XLA_FLAGS`` set before jax starts, so each runs
in ONE subprocess that returns every result at once (a 2-device one for
the train steps and checkpoints, a 4-device one for the composed batches).
The port's sides are ``gloo`` worlds of CPU processes
(``tests/torch_dp_world.py``), one world a case group, each given a
deadline and killed after it.  All four start together in one module
fixture; the tests read their results.

Tolerance of the train steps, f32 on the CPU: every metric of every step
(loss, accuracy or aux loss, grad_norm) at rtol 1e-5, atol 1e-6, and so the
parameters and BatchNorm statistics of the SGD ResNet after 3 steps (they
land within 6e-8).  The ranks' BatchNorm merges each rank's two-pass
moments (Chan's parallel variance) where the reference's jit reduces two
passes over the whole batch; that and the orders of the reductions are all
that differ.  In float64 the ranks' gradients and BatchNorm statistics
equal one process's to 1e-12 (:func:`test_global_batchnorm_is_exact_in_float64`),
so the rest is f32 rounding, which the network's backward at its initial
weights magnifies.  Elsewhere the parameters
take a per-case absolute tolerance (``CASES[...]["atol"]``, rtol 1e-5),
because the optimizer magnifies those roundings where the comparison is
not about data parallelism: AdamW moves each weight by about the learning
rate whatever its gradient's size, so the ResNet's stem convolution, whose
gradient cancels through BatchNorm, lands 3.3e-4 from the reference (lr
0.05) and the MoE's experts 1.7e-5 (lr 1e-3); int8 error feedback moves a
weight by a quantum where a rounding lands the other way (4e-6).  One port
process on the same global batches lands as far from the reference
(2.3e-4, 1.7e-5, 6e-6), as the single-process twins allow (rtol and atol
1e-4 in ``test_torch_train.py`` and ``test_torch_lm.py``).
"""
import json
import pickle
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_world as worlds  # noqa: E402

from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import resnet_to_jax, to_jax  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.launch.mesh import RankDevice, make_mesh  # noqa: E402
from repro_torch.models import moe, resnet, transformer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
WORLD_DEADLINE_S = 420.0
STEPS = 3

# each case: its arch, its TrainConfig fields, and the model overrides
RESNET_HP = dict(learning_rate=0.05, warmup_steps=2, total_steps=6, grad_clip=0.5,
                 weight_decay=1e-2)
LM_HP = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, weight_decay=1e-2)
SGD_LM_HP = dict(LM_HP, learning_rate=0.05)
# "atol": the parameters' absolute tolerance after 3 steps (see the module
# docstring; every metric of every step is held at TOL)
CASES = {
    "resnet_sgd": {"arch": "resnet18-imagenet", "train": dict(optimizer="sgd", **RESNET_HP),
                   "atol": 1e-6},
    # lr / 50
    "resnet_adamw": {"arch": "resnet18-imagenet", "train": dict(optimizer="adamw", **RESNET_HP),
                     "atol": 1e-3},
    # an int8 rounding that lands the other way moves one weight by lr times
    # its tensor's quantum (max |g| / 127)
    "granite_int8_ef": {"arch": "granite-8b",
                        "train": dict(optimizer="sgd", microbatches=2,
                                      grad_compression="int8_ef", **SGD_LM_HP),
                        "atol": 1e-5},
    # 4 rows of 16 tokens a rank: 64 tokens, groups of 32 divide them; lr / 10
    "granite_moe": {"arch": "granite-moe-3b-a800m", "group_size": 32,
                    "train": dict(optimizer="adamw", **LM_HP), "atol": 1e-4},
}
# the same MoE at the default group size (4096): one group of 128 tokens over
# the global batch, which each rank's 64 tokens would cut in two
STRADDLE = {"arch": "granite-moe-3b-a800m", "train": dict(optimizer="adamw", **LM_HP)}
GLOBAL_BS, ITEMS, SEQ = 8, 48, 16

# both sides build their configs, datasets and loaders from these lines
SETUP = r'''
def model_config(case, get_arch, replace):
    cfg = get_arch(case["arch"], smoke=True)
    if cfg.family == "resnet":
        # synthetic ImageNet draws labels 0..999: the smoke head's 10 would read NaN
        return replace(cfg, num_classes=1000)
    cfg = replace(cfg, dtype="float32")
    if "group_size" in case:
        cfg = replace(cfg, moe=replace(cfg.moe, group_size=case["group_size"]))
    return cfg


def dataset(cfg, pkg):
    if cfg.family == "resnet":
        return pkg.ImageDataset(pkg.SyntheticImageStore(ITEMS, seed=0, avg_kb=4), ITEMS,
                                out_size=32, augment=False)
    base = pkg.InMemoryStore()
    pkg.build_token_store(base, ITEMS, SEQ, cfg.vocab_size)
    return pkg.TokenDataset(base, ITEMS, SEQ)


def loader(cfg, pkg, delivery):
    return pkg.make_loader(
        pkg.LoaderConfig(batch_size=GLOBAL_BS, seed=3, delivery=delivery,
                         pipeline=pkg.PipelineConfig(enabled=True, io_workers=8)),
        dataset(cfg, pkg))


def metric_keys(cfg):
    return ("loss", "accuracy", "grad_norm") if cfg.family == "resnet" else (
        "loss", "aux_loss", "grad_norm")
'''

PORT_RANKS = r'''
import json, os, pickle, sys, time, types
from dataclasses import replace
import numpy as np
import torch
from repro_torch.config import DeliverySpec, LoaderConfig, PipelineConfig, TrainConfig, get_arch
from repro_torch.convert import (RESNET_LAYOUT, checkpoint_layout, lm_params_from_jax,
                                 resnet_state_from_jax, resnet_to_jax, to_jax)
from repro_torch.core import make_loader
from repro_torch.data.dataset import ImageDataset, TokenDataset, build_token_store
from repro_torch.data.imagenet_synth import SyntheticImageStore
from repro_torch.data.store import InMemoryStore
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.steps import (lm_train_state, make_resnet_train_step, make_train_step,
                                     resnet_train_state)
from repro_torch.tree import flatten

out, url, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
ITEMS, SEQ, GLOBAL_BS, STEPS = spec["items"], spec["seq"], spec["global_bs"], spec["steps"]
exec(spec["setup"])
pkg = types.SimpleNamespace(ImageDataset=ImageDataset, SyntheticImageStore=SyntheticImageStore,
                            InMemoryStore=InMemoryStore, build_token_store=build_token_store,
                            TokenDataset=TokenDataset, make_loader=make_loader,
                            LoaderConfig=LoaderConfig, PipelineConfig=PipelineConfig)
dist.init_process_group("gloo", url, "cpu", timeout_s=300)
r, W = dist.rank(), dist.world_size()
with open(spec["weights"], "rb") as f:
    weights = pickle.load(f)
mesh = make_mesh((W,), ("data",))
rec = {"rank": r, "world": W}


def state_of(case, cfg, tcfg):
    w = weights[case]
    if cfg.family == "resnet":
        return resnet_train_state(*resnet_state_from_jax(w["params"], w["bn"], "cpu"), tcfg)
    return lm_train_state(lm_params_from_jax(w["params"], "cpu"), tcfg)


def step_of(cfg, tcfg):
    return (make_resnet_train_step if cfg.family == "resnet" else make_train_step)(cfg, tcfg)


def ref_layout(cfg, tree):
    return flatten(resnet_to_jax(tree) if cfg.family == "resnet" else to_jax(tree))


for case, c in spec["cases"].items():
    cfg, tcfg = model_config(c, get_arch, replace), TrainConfig(**c["train"])
    state, step = state_of(case, cfg, tcfg), step_of(cfg, tcfg)
    ld = loader(cfg, pkg, DeliverySpec.sharded(mesh))
    it = iter(ld)
    metrics, rows = [], []
    for _ in range(STEPS):
        batch = next(it)
        rows.append({k: v.numpy().tolist() for k, v in batch.items()
                     if k in ("label", "tokens")})
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in metric_keys(cfg)})
    arrays = {f"params/{k}": v for k, v in ref_layout(cfg, state["params"]).items()}
    if cfg.family == "resnet":
        arrays.update({f"bn/{k}": v for k, v in ref_layout(cfg, state["bn"]).items()})
    np.savez(os.path.join(out, f"{case}_rank{r}.npz"), **arrays)
    lo, hi = dist.checksum_range({k: v for k, v in state.items() if k != "step"})
    rec[case] = {"metrics": metrics, "rows": rows, "checksum": [lo, hi],
                 "grad_allreduce_calls": step.grad_reduce.calls,
                 "grad_allreduce_bytes": step.grad_reduce.bytes}
    if case == "resnet_sgd":
        # the port's checkpoint at step STEPS: rank 0 writes, every rank's
        # lane in the block; then one more step (the reference restores it)
        extra = {"loader": ld.cursor_state(0, STEPS)}
        if r == 0:
            CheckpointManager(os.path.join(out, "port_ckpt"),
                              layout=checkpoint_layout(cfg)).save(STEPS, state,
                                                                  extra_meta=extra)
        dist.barrier()
        rec["port_ckpt_block"] = extra["loader"]
        batch = next(it)
        state, m = step(state, batch)
        rec["port_next"] = {"loss": float(m["loss"]), "label": batch["label"].tolist()}
        # the reference's checkpoint at the same step, restored on every rank
        ref_dir = os.path.join(out, "ref_ckpt")
        deadline = time.monotonic() + 300
        while not os.path.isdir(os.path.join(ref_dir, f"step_{STEPS:08d}")):
            if time.monotonic() > deadline:
                raise SystemExit("no reference checkpoint")
            time.sleep(0.1)
        state, meta = CheckpointManager(ref_dir, layout=checkpoint_layout(cfg)).restore(
            state_of(case, cfg, tcfg))
        fresh = loader(cfg, pkg, DeliverySpec.sharded(mesh))
        fresh.load_state_dict(meta["extra"]["loader"])
        fit = iter(fresh)
        batch = next(fit)
        state, m = step(state, batch)
        rec["from_ref"] = {"step": state["step"], "loss": float(m["loss"]),
                           "label": batch["label"].tolist(),
                           "cursor": fresh.state_dict()["next_batch"]}
        fit.shutdown()
    it.shutdown()

# an MoE shape whose groups would straddle the ranks: refused before the step
cfg, tcfg = model_config(spec["straddle"], get_arch, replace), TrainConfig(**spec["straddle"]["train"])
state, step = lm_train_state(lm_params_from_jax(weights["granite_moe"]["params"], "cpu"), tcfg), \
    make_train_step(cfg, tcfg)
sit = iter(loader(cfg, pkg, DeliverySpec.sharded(mesh)))
batch = next(sit)
sit.shutdown()
try:
    step(state, batch)
    rec["straddle"] = {"raised": False}
except ValueError as e:
    rec["straddle"] = {"raised": True, "message": str(e), "step": state["step"]}
with open(os.path.join(out, f"rank{r}.json"), "w") as f:
    json.dump(rec, f)
dist.destroy_process_group()
'''

REFERENCE_2DEV = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json, pickle, time, types
from dataclasses import replace
import numpy as np
import jax
import jax.numpy as jnp
from repro.config import DeliverySpec, LoaderConfig, PipelineConfig, TrainConfig, get_arch
from repro.core import make_loader
from repro.data.dataset import ImageDataset, TokenDataset, build_token_store
from repro.data.imagenet_synth import SyntheticImageStore
from repro.data.store import InMemoryStore
from repro.launch.mesh import make_mesh
from repro.train import compression
from repro.train.checkpoint import CheckpointManager, _flatten
from repro.train.optim import make_optimizer
from repro.train.steps import make_resnet_train_step, make_train_step

out, spec = sys.argv[1], json.loads(sys.argv[2])
ITEMS, SEQ, GLOBAL_BS, STEPS = spec["items"], spec["seq"], spec["global_bs"], spec["steps"]
exec(spec["setup"])
pkg = types.SimpleNamespace(ImageDataset=ImageDataset, SyntheticImageStore=SyntheticImageStore,
                            InMemoryStore=InMemoryStore, build_token_store=build_token_store,
                            TokenDataset=TokenDataset, make_loader=make_loader,
                            LoaderConfig=LoaderConfig, PipelineConfig=PipelineConfig)
with open(spec["weights"], "rb") as f:
    weights = pickle.load(f)
mesh = make_mesh((2,), ("data",))
rec = {}


def state_of(case, cfg, tcfg):
    w = weights[case]
    params = jax.tree.map(jnp.asarray, w["params"])
    st = {"params": params, "opt": make_optimizer(tcfg).init(params),
          "step": jnp.zeros((), jnp.int32)}
    if cfg.family == "resnet":
        st["bn"] = jax.tree.map(jnp.asarray, w["bn"])
    if tcfg.grad_compression == "int8_ef":
        st["ef"] = compression.init_error_feedback(params)
    return st


def flat(tree):
    return {k: np.asarray(v) for k, v in _flatten(jax.device_get(tree)).items()}


for case, c in spec["cases"].items():
    cfg, tcfg = model_config(c, get_arch, replace), TrainConfig(**c["train"])
    state = state_of(case, cfg, tcfg)
    step = jax.jit((make_resnet_train_step if cfg.family == "resnet" else make_train_step)(
        cfg, tcfg))
    ld = loader(cfg, pkg, DeliverySpec.sharded(mesh, axis="data"))
    it = iter(ld)
    metrics, rows = [], []
    for _ in range(STEPS):
        batch = next(it)
        rows.append({k: np.asarray(v).tolist() for k, v in batch.items()
                     if k in ("label", "tokens")})
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in metric_keys(cfg)})
    arrays = {f"params/{k}": v for k, v in flat(state["params"]).items()}
    if cfg.family == "resnet":
        arrays.update({f"bn/{k}": v for k, v in flat(state["bn"]).items()})
    np.savez(os.path.join(out, f"{case}_ref.npz"), **arrays)
    rec[case] = {"metrics": metrics, "rows": rows}
    if case == "resnet_sgd":
        CheckpointManager(os.path.join(out, "ref_ckpt")).save(
            STEPS, state, extra_meta={"loader": ld.state_dict()})
        batch = next(it)
        state, m = step(state, batch)
        rec["ref_next"] = {"loss": float(m["loss"]), "label": np.asarray(batch["label"]).tolist()}
        port_dir = os.path.join(out, "port_ckpt")
        deadline = time.monotonic() + 300
        while not os.path.isdir(os.path.join(port_dir, f"step_{STEPS:08d}")):
            if time.monotonic() > deadline:
                raise SystemExit("no port checkpoint")
            time.sleep(0.1)
        state, meta = CheckpointManager(port_dir).restore(state_of(case, cfg, tcfg))
        fresh = loader(cfg, pkg, DeliverySpec.sharded(mesh, axis="data"))
        fresh.load_state_dict(meta["extra"]["loader"])
        fit = iter(fresh)
        batch = next(fit)
        state, m = step(state, batch)
        rec["from_port"] = {"step": int(state["step"]), "loss": float(m["loss"]),
                            "label": np.asarray(batch["label"]).tolist(),
                            "cursor": fresh.state_dict()["next_batch"]}
        fit.shutdown()
    it.shutdown()
print(json.dumps(rec))
'''

# the composed batches on four ranks (the twin of test_torch_delivery.py's
# test_sharded_delivery_end_to_end_4dev, whose loaders these are)
BATCHES = r'''
def image_loader(pkg, delivery, items=96):
    return pkg.make_loader(
        pkg.LoaderConfig(batch_size=16, seed=3, delivery=delivery,
                         pipeline=pkg.PipelineConfig(enabled=True, io_workers=8)),
        pkg.ImageDataset(pkg.SyntheticImageStore(items, seed=0, avg_kb=4), items, out_size=32,
                         augment=False))


def composed(pkg, mesh, as_numpy):
    rec, arrays = {}, {}
    ld = image_loader(pkg, pkg.DeliverySpec.sharded(mesh))
    for i, b in enumerate(ld):
        arrays.update({f"sharded/{i}/{k}": as_numpy(v) for k, v in b.items()})
    first = image_loader(pkg, pkg.DeliverySpec.sharded(mesh))
    it = iter(first)
    for _ in range(2):
        next(it)
    rec["state"] = first.state_dict()
    it.shutdown()
    resumed = image_loader(pkg, pkg.DeliverySpec.sharded(mesh))
    resumed.load_state_dict(rec["state"])
    for i, b in enumerate(resumed):
        arrays.update({f"resumed/{i}/{k}": as_numpy(v) for k, v in b.items()})
    two = dict(rec["state"], delivery=dict(rec["state"]["delivery"], num_lanes=2))
    try:
        image_loader(pkg, pkg.DeliverySpec.sharded(mesh)).load_state_dict(two)
        rec["two_lanes_refused"] = None
    except ValueError as e:
        rec["two_lanes_refused"] = str(e)
    return rec, arrays
'''

PORT_BATCHES = r'''
import json, os, sys, types
import numpy as np
from repro_torch.config import DeliverySpec, LoaderConfig, PipelineConfig
from repro_torch.core import make_loader
from repro_torch.data.dataset import ImageDataset
from repro_torch.data.imagenet_synth import SyntheticImageStore
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_mesh

out, url, code = sys.argv[1], sys.argv[2], sys.argv[3]
exec(code)
pkg = types.SimpleNamespace(make_loader=make_loader, LoaderConfig=LoaderConfig,
                            PipelineConfig=PipelineConfig, ImageDataset=ImageDataset,
                            SyntheticImageStore=SyntheticImageStore, DeliverySpec=DeliverySpec)
dist.init_process_group("gloo", url, "cpu", timeout_s=300)
r = dist.rank()
mesh = make_mesh((dist.world_size(),), ("data",))
plan = image_loader(pkg, DeliverySpec.sharded(mesh)).delivery_plan
rec, arrays = composed(pkg, mesh, lambda v: v.numpy())
rec["plan"] = {"num_lanes": plan.num_lanes, "global_mult": plan.global_mult,
               "host_rows": plan.host_rows, "process_index": plan.process_index,
               "compose_device": str(plan.compose_device())}
np.savez(os.path.join(out, f"batches_rank{r}.npz"), **arrays)
with open(os.path.join(out, f"batches_rank{r}.json"), "w") as f:
    json.dump(rec, f)
dist.destroy_process_group()
'''

REFERENCE_4DEV = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, types
import numpy as np
import jax
from repro.config import DeliverySpec, LoaderConfig, PipelineConfig
from repro.core import make_loader
from repro.data.dataset import ImageDataset
from repro.data.imagenet_synth import SyntheticImageStore
from repro.launch.mesh import make_mesh

out, code = sys.argv[1], sys.argv[2]
exec(code)
pkg = types.SimpleNamespace(make_loader=make_loader, LoaderConfig=LoaderConfig,
                            PipelineConfig=PipelineConfig, ImageDataset=ImageDataset,
                            SyntheticImageStore=SyntheticImageStore, DeliverySpec=DeliverySpec)
mesh = make_mesh((4,), ("data",))
rec, arrays = composed(pkg, mesh, lambda v: np.asarray(jax.device_get(v)))
for i, b in enumerate(image_loader(pkg, DeliverySpec.host())):
    arrays.update({f"host/{i}/{k}": np.asarray(v) for k, v in b.items()})
# the per-device shards of the first sharded batch, in device order
b0 = next(iter(image_loader(pkg, DeliverySpec.sharded(mesh))))
for k, v in b0.items():
    for s in sorted(v.addressable_shards, key=lambda s: s.device.id):
        arrays[f"shard0/{s.device.id}/{k}"] = np.asarray(s.data)
np.savez(os.path.join(out, "batches_ref.npz"), **arrays)
print(json.dumps(rec))
'''


def _weights(path):
    """Each case's initial weights, drawn by the port from a seed and carried
    to both sides in the reference's layout."""
    out = {}
    for name, case in CASES.items():
        cfg = _port_cfg(case)
        g = torch.Generator().manual_seed(0)
        if cfg.family == "resnet":
            params, bn = resnet.init_resnet(cfg, g, "cpu")
            out[name] = {"params": resnet_to_jax(params), "bn": resnet_to_jax(bn)}
        else:
            out[name] = {"params": to_jax(transformer.init_lm(cfg, g, "cpu"))}
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _port_cfg(case):
    ns = {"ITEMS": ITEMS, "SEQ": SEQ, "GLOBAL_BS": GLOBAL_BS}
    exec(SETUP, ns)
    return ns["model_config"](case, get_arch, replace)


def _spec(weights):
    return json.dumps({"items": ITEMS, "seq": SEQ, "global_bs": GLOBAL_BS, "steps": STEPS,
                       "setup": SETUP, "cases": CASES, "straddle": STRADDLE,
                       "weights": str(weights)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four runs, started together: the port's 2-rank and 4-rank gloo
    worlds and the reference's 2- and 4-device subprocesses."""
    out = tmp_path_factory.mktemp("dp")
    weights = out / "weights.pkl"
    _weights(weights)
    spec = _spec(weights)
    env = worlds.rank_env(0, 1)
    procs = {
        "port2": worlds.start_world(["-c", PORT_RANKS, str(out), worlds.init_url(out, "rdv2"),
                                     spec], 2),
        "port4": worlds.start_world(["-c", PORT_BATCHES, str(out),
                                     worlds.init_url(out, "rdv4"), BATCHES], 4),
    }
    import subprocess

    refs = {
        "ref2": subprocess.Popen([sys.executable, "-c", REFERENCE_2DEV, str(out), spec],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=str(ROOT)),
        "ref4": subprocess.Popen([sys.executable, "-c", REFERENCE_4DEV, str(out), BATCHES],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=str(ROOT)),
    }
    t0 = time.monotonic()
    try:
        done = {name: worlds.finish_world(p, WORLD_DEADLINE_S) for name, p in procs.items()}
        done.update({name: worlds.finish_world([p], WORLD_DEADLINE_S - (time.monotonic() - t0))
                     for name, p in refs.items()})
    finally:
        for p in list(refs.values()) + [q for ps in procs.values() for q in ps]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, ranks in done.items():
        for rc, o, e in ranks:
            assert rc == 0, f"{name}: exit {rc}\n{o[-2000:]}\n{e[-3000:]}"
    res = {"dir": out,
           "port2": [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)],
           "port4": [json.loads((out / f"batches_rank{r}.json").read_text()) for r in range(4)],
           "ref2": json.loads(done["ref2"][0][1].strip().splitlines()[-1]),
           "ref4": json.loads(done["ref4"][0][1].strip().splitlines()[-1])}
    return res


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------
# one process: no group
# --------------------------------------------------------------------------


def test_without_a_group_every_function_reports_one_rank():
    assert not dist.is_initialized()
    assert (dist.rank(), dist.world_size()) == (0, 1)
    assert dist.backend() is None and dist.device() is None
    t = torch.arange(4.0)
    assert dist.all_reduce_(t) is t and t.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert dist.all_gather_object({"a": 1}) == [{"a": 1}]
    tree = {"w": torch.ones(2)}
    assert dist.broadcast_tree_(tree) is tree
    assert [g.tolist() for g in dist.group_mean([torch.ones(2), torch.zeros(1)])] == [
        [1.0, 1.0], [0.0]]
    lo, hi = dist.checksum_range(tree)
    assert lo == hi == dist.tree_checksum({"w": torch.ones(2)})
    assert dist.tree_checksum({"w": torch.tensor([1.0, 0.0])}) != dist.tree_checksum(
        {"w": torch.tensor([0.0, 1.0])})
    dist.barrier()


def test_rank_device_rules():
    """``cuda`` is the rank's ``cuda:LOCAL_RANK`` and raises when that card
    is not visible; ``cpu`` is the CPU; a backend outside nccl and gloo is
    refused before any rendezvous."""
    with pytest.raises(ValueError, match=r"LOCAL_RANK \d+ is not a visible card"):
        dist.rank_device("cuda", local=torch.cuda.device_count() + 3)
    assert dist.rank_device("cpu", local=5) == torch.device("cpu")
    assert dist._device_name("cuda", 2) == "cuda:2" and dist._device_name("cuda:0", 2) == "cuda:0"
    with pytest.raises(ValueError, match="unknown backend"):
        dist.init_process_group("mpi", "file:///nonexistent", "cpu")


def test_make_mesh_keeps_its_single_process_behaviour():
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    assert [str(d) for d in mesh.devices.flat] == ["cpu"] * 4
    assert RankDevice(3).process_index == 3


def test_moe_group_layout_is_apply_moes():
    """``group_layout`` is the cut ``apply_moe`` makes (padding included), and
    the rank check passes exactly where a global group is a whole group of
    one rank."""
    cfg = _port_cfg(CASES["granite_moe"])
    assert moe.group_layout(128, 32) == (4, 32)
    assert moe.group_layout(100, 32) == (4, 25)
    assert moe.group_layout(96, 64, dp=4) == (4, 24)
    moe.check_rank_groups(cfg, rows=4, seq_len=16, world=2)
    # 48 tokens cut into 2 groups of 24: each rank's 24 tokens are one group
    moe.check_rank_groups(cfg, rows=2, seq_len=12, world=2)
    with pytest.raises(ValueError, match="straddle ranks"):  # 80 into 3 of 27
        moe.check_rank_groups(cfg, rows=2, seq_len=20, world=2)
    with pytest.raises(ValueError, match="straddle ranks"):
        moe.check_rank_groups(_port_cfg(STRADDLE), rows=4, seq_len=16, world=2)


# --------------------------------------------------------------------------
# (i) four ranks compose the reference's batches
# --------------------------------------------------------------------------


def test_four_ranks_compose_the_reference_batches(runs):
    """Each of four ranks composes its rows of every global batch on its own
    device; the ranks' rows concatenated in rank order equal the reference's
    host batches and its 4-device sharded gather bit for bit, rank r's rows
    equal device r's shard, and a resumed world equals an unbroken one."""
    ref = _npz(runs["dir"] / "batches_ref.npz")
    ranks = [_npz(runs["dir"] / f"batches_rank{r}.npz") for r in range(4)]
    for kind in ("sharded", "resumed"):
        keys = sorted(k for k in ranks[0] if k.startswith(kind + "/"))
        assert keys and keys == sorted(k for k in ref if k.startswith(kind + "/"))
        for k in keys:
            got = np.concatenate([rk[k] for rk in ranks])
            np.testing.assert_array_equal(got, ref[k], err_msg=k)
            if kind == "sharded":
                np.testing.assert_array_equal(got, ref["host/" + k.split("/", 1)[1]], err_msg=k)
    n = sum(1 for k in ranks[0] if k.startswith("sharded/") and k.endswith("/label"))
    assert n == 96 // 16
    for r in range(4):
        for k in ("image", "label"):
            np.testing.assert_array_equal(ranks[r][f"sharded/0/{k}"], ref[f"shard0/{r}/{k}"])
    for r, rec in enumerate(runs["port4"]):
        assert rec["plan"] == {"num_lanes": 1, "global_mult": 4, "host_rows": 4,
                               "process_index": r, "compose_device": "cpu"}


def test_four_rank_lane_block_is_the_reference_block(runs):
    """After two batches every rank's state holds the reference's 4-lane
    block (cursors ``[2, 2, 2, 2]``); a 2-lane block is refused on both
    sides."""
    want = runs["ref4"]["state"]
    for rec in runs["port4"]:
        got = rec["state"]
        assert [ln["next_batch"] for ln in got["delivery"]["lanes"]] == [2, 2, 2, 2]
        assert [ln["lane"] for ln in got["delivery"]["lanes"]] == [0, 1, 2, 3]

        def no_devices(st):  # the ranks' four CPU devices are all device 0
            return dict(st, delivery=dict(st["delivery"], lanes=[
                {k: v for k, v in ln.items() if k != "devices"}
                for ln in st["delivery"]["lanes"]]))

        assert no_devices(got) == no_devices(want)
        assert "delivery lanes" in rec["two_lanes_refused"]
    assert runs["ref4"]["two_lanes_refused"]


# --------------------------------------------------------------------------
# (ii) two ranks against the reference's 2-device sharded step; (v) ranks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_reference_step(runs, case):
    """Two gloo ranks, each stepping on its rows of the global batch, against
    the reference's jitted step on a 2-device mesh fed by its own sharded
    delivery, from the same weights: each step's metrics, and after 3 steps
    the parameters (and the ResNet's BatchNorm running statistics)."""
    ref = runs["ref2"][case]
    for rec in runs["port2"]:
        got = rec[case]
        # the rank's rows are its slice of the reference's global batch
        for g, w in zip(got["rows"], ref["rows"]):
            for k, v in g.items():
                per = len(w[k]) // 2
                assert v == w[k][rec["rank"] * per:(rec["rank"] + 1) * per]
        for s, (g, w) in enumerate(zip(got["metrics"], ref["metrics"])):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=f"step {s + 1} {k}", **TOL)
        assert got["grad_allreduce_calls"] == STEPS
    want = _npz(runs["dir"] / f"{case}_ref.npz")
    for r in range(2):
        port = _npz(runs["dir"] / f"{case}_rank{r}.npz")
        assert set(port) == set(want)
        for k in want:
            np.testing.assert_allclose(port[k], want[k], err_msg=k, rtol=TOL["rtol"],
                                       atol=CASES[case]["atol"])
    if case.startswith("resnet"):
        assert any(k.startswith("bn/") for k in want)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_hold_bit_equal_parameters(runs, case):
    """The two ranks' parameters (and BatchNorm statistics) are bit-equal
    after the steps, and so is every leaf of their state (checksums)."""
    a, b = (_npz(runs["dir"] / f"{case}_rank{r}.npz") for r in range(2))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for rec in runs["port2"]:
        lo, hi = rec[case]["checksum"]
        assert lo == hi


# --------------------------------------------------------------------------
# (iii) straddling MoE groups; (iv) checkpoints across packages
# --------------------------------------------------------------------------


def test_moe_groups_straddling_ranks_are_refused(runs):
    for rec in runs["port2"]:
        st = rec["straddle"]
        assert st["raised"] and st["step"] == 0
        assert "straddle ranks" in st["message"] and "2 ranks of 4 x 16 tokens" in st["message"]


def test_port_checkpoint_restores_into_the_reference(runs):
    """Rank 0 writes the 2-rank checkpoint (``arrays_h0.npz``, the 2-lane
    block gathered from both ranks); the reference restores it into its
    2-device loader and state, and its next step is the port's."""
    for rec in runs["port2"]:
        block = rec["port_ckpt_block"]
        assert block["delivery"]["num_lanes"] == 2
        assert [ln["next_batch"] for ln in block["delivery"]["lanes"]] == [STEPS, STEPS]
    files = sorted(p.name for p in (runs["dir"] / "port_ckpt" / f"step_{STEPS:08d}").iterdir())
    assert files == ["arrays_h0.npz", "meta.json"]
    got = runs["ref2"]["from_port"]
    ranks = [rec["port_next"] for rec in runs["port2"]]
    assert got["step"] == STEPS + 1 and got["cursor"] == STEPS + 1
    assert got["label"] == ranks[0]["label"] + ranks[1]["label"] == runs["ref2"]["ref_next"][
        "label"]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(got["loss"], ranks[0]["loss"], **TOL)


def test_reference_checkpoint_restores_into_every_rank(runs):
    """The reference's 2-device checkpoint (state and 2-lane block) restores
    on both ranks; each rank takes its lane, and the next step's loss and
    rows are the reference's."""
    want = runs["ref2"]["ref_next"]
    for rec in runs["port2"]:
        got = rec["from_ref"]
        assert got["step"] == STEPS + 1 and got["cursor"] == STEPS + 1
        per = len(want["label"]) // 2
        assert got["label"] == want["label"][rec["rank"] * per:(rec["rank"] + 1) * per]
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)


# --------------------------------------------------------------------------
# global BatchNorm, exact in float64
# --------------------------------------------------------------------------

BN_EXACT = r"""
import pickle, sys
import torch
from repro_torch.config import get_arch
from repro_torch.launch import dist
from repro_torch.models import resnet
from repro_torch.tree import flatten, leaves, tree_map

dist.init_process_group("gloo", sys.argv[2], "cpu", timeout_s=120)
cfg = get_arch("resnet18-imagenet", smoke=True)
params, bn = resnet.init_resnet(cfg, torch.Generator().manual_seed(0), "cpu")
params, bn = (tree_map(lambda t: t.double(), t) for t in (params, bn))
for p in leaves(params):
    p.requires_grad_(True)
g = torch.Generator().manual_seed(1)
x = torch.randn(8, 3, 32, 32, generator=g, dtype=torch.float64)
y = torch.randint(0, cfg.num_classes, (8,), generator=g)
per = 8 // dist.world_size()
rows = slice(dist.rank() * per, (dist.rank() + 1) * per)


def grads():
    loss, (new_bn, _) = resnet.resnet_loss(params, bn, {"image": x[rows], "label": y[rows]},
                                           cfg, train=True)
    gs = torch.autograd.grad(loss, leaves(params))
    return ([dist.all_reduce_(t.clone()) / dist.world_size() for t in gs],
            flatten(new_bn))


out = {"exact": grads()}
resnet._GroupSum.backward = staticmethod(lambda ctx, t: t.clone())  # the planted fault
out["backward_unreduced"] = grads()
if dist.rank() == 0:
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def bn_exact(tmp_path_factory):
    """Two gloo ranks' float64 gradients and BatchNorm statistics of one
    step of the smoke ResNet, honest and with the backward of the
    statistics' all-reduce left unreduced."""
    out = tmp_path_factory.mktemp("bn_exact")
    for rc, o, e in worlds.run_world(["-c", BN_EXACT, str(out / "ranks.pkl"),
                                      worlds.init_url(out)], 2, 120.0):
        assert rc == 0, f"exit {rc}\n{o[-2000:]}\n{e[-3000:]}"
    with open(out / "ranks.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("case", ["exact", "backward_unreduced"])
def test_global_batchnorm_is_exact_in_float64(bn_exact, case):
    """One step of the smoke ResNet in float64: two ranks' mean gradient
    and BatchNorm running statistics equal one process's on the whole batch
    to 1e-12 (relative, over all leaves), so global BatchNorm's forward and
    backward compute the global batch's; with the backward all-reduce
    dropped the gradients are off by more than 1e-3."""
    from repro_torch.tree import flatten, leaves, tree_map

    cfg = get_arch("resnet18-imagenet", smoke=True)
    params, bn = resnet.init_resnet(cfg, torch.Generator().manual_seed(0), "cpu")
    params, bn = (tree_map(lambda t: t.double(), t) for t in (params, bn))
    for p in leaves(params):
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 3, 32, 32, generator=g, dtype=torch.float64)
    y = torch.randint(0, cfg.num_classes, (8,), generator=g)
    loss, (new_bn, _) = resnet.resnet_loss(params, bn, {"image": x, "label": y}, cfg, train=True)
    want = torch.autograd.grad(loss, leaves(params))
    got, got_bn = bn_exact[case]

    def rel(a, b):
        num = sum(float((u - v).square().sum()) for u, v in zip(a, b))
        return (num / sum(float(v.square().sum()) for v in b)) ** 0.5

    want_bn = flatten(new_bn)
    bn_gap = rel([got_bn[k] for k in want_bn], list(want_bn.values()))
    assert bn_gap < 1e-12
    if case == "exact":
        assert rel(got, want) < 1e-12
    else:
        assert rel(got, want) > 1e-3
