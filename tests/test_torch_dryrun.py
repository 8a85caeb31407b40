"""The port's dry run (``repro_torch.launch.dryrun``) and its specs
(``repro_torch.launch.specs``): the twin of ``tests/test_dryrun_small.py``
(granite-moe-3b-a800m smoke on a (2, 4) mesh, a train cell and a decode
cell with its cache), every spec's shapes, dtypes and partition specs
against the reference's ``eval_shape`` specs for the smoke config of each
assigned arch, one record through the CLI, and jamba's train-step FLOPs
against the reference's ``analyze_hlo`` (kept here, beside the other
reference compiles, so ``test_torch_roofline.py`` stays near 30 s).

The reference needs 8 devices, which ``XLA_FLAGS`` gives only before jax
starts, so its side runs in ONE subprocess that returns every spec at
once; the port's mesh is ``["cpu"] * 8``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import ShapeConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402
from torch_cost_cells import jax_train_flops, lm_train_cost  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ShapeConfig("t", 128, 8, "train")
DECODE = ShapeConfig("d", 64, 8, "decode")

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from repro.config import ShapeConfig, TrainConfig, get_arch
from repro.launch import specs as S
from repro.launch.mesh import make_mesh

archs = json.loads(sys.argv[1])
mesh = make_mesh((2, 4), ("data", "model"))
train, decode = ShapeConfig("t", 128, 8, "train"), ShapeConfig("d", 64, 8, "decode")


def path_of(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def entry(e):
    return list(e) if isinstance(e, tuple) else e


def table(tree):
    out = {}
    jax.tree_util.tree_map_with_path(lambda kp, s: out.__setitem__(path_of(kp), [
        list(s.shape), str(s.dtype), [entry(e) for e in s.sharding.spec]]), tree)
    return out


res = {}
for name in archs:
    cfg = get_arch(name, smoke=True)
    tcfg = TrainConfig(optimizer="adafactor" if name == "jamba-v0.1-52b" else "adamw")
    state = S.state_specs(cfg, tcfg, mesh)
    res[name] = {"input_train": table(S.input_specs(cfg, train, mesh)),
                 "input_decode": table(S.input_specs(cfg, decode, mesh)),
                 "params": table(state["params"]), "opt": table(state["opt"]),
                 "serving": table(S.param_specs_only(cfg, mesh)),
                 "cache": table(S.cache_specs(cfg, decode, mesh))}
print(json.dumps(res))
'''

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int32: "int32"}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(ASSIGNED)],
                         capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh():
    return make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)


def _table(tree):
    def spec(t):
        entries = [list(e) if isinstance(e, tuple) else e for e in t.sharding.spec]
        return entries + [None] * (t.dim() - len(entries))

    return {p: [list(t.shape), _DTYPES[t.dtype], spec(t)] for p, t in flatten(tree).items()}


def _norm(table):
    """The reference's specs padded to each leaf's rank (a PartitionSpec may
    leave trailing dims out)."""
    return {p: [s, d, spec + [None] * (len(s) - len(spec))] for p, (s, d, spec) in table.items()}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_equal_the_references(reference, arch):
    cfg = get_arch(arch, smoke=True)
    tcfg = TrainConfig(optimizer="adafactor" if arch == "jamba-v0.1-52b" else "adamw")
    mesh = _mesh()
    with op_cost.fake_mode() as mode:
        state = S.state_specs(cfg, tcfg, mesh, mode=mode)
        ours = {"input_train": _table(S.input_specs(cfg, TRAIN, mesh, mode=mode)),
                "input_decode": _table(S.input_specs(cfg, DECODE, mesh, mode=mode)),
                "params": _table(state["params"]), "opt": _table(state["opt"]),
                "serving": _table(S.param_specs_only(cfg, mesh, mode=mode)),
                "cache": _table(S.cache_specs(cfg, DECODE, mesh, mode=mode))}
    assert state["step"] == 0  # a host int in the port
    for kind, want in reference[arch].items():
        assert ours[kind] == _norm(want), kind


def test_dryrun_small_mesh():
    """The twin of ``test_dryrun_small_mesh``: a train cell and a decode cell
    (with ``cache_specs``) of the MoE smoke model on the (2, 4) mesh count
    FLOPs and bytes, and the state a device holds is the specs' share.  One
    process runs no collective, so the wire bytes are 0 (the reference's
    compiled SPMD module has them)."""
    cfg = get_arch("granite-moe-3b-a800m", smoke=True)  # exercises MoE + EP pad
    tcfg = TrainConfig(microbatches=2)
    mesh = _mesh()
    cost, state_bytes, _ = dryrun.count_program(cfg, tcfg, TRAIN, mesh)
    assert cost.flops > 0 and cost.traffic_bytes > 0 and cost.wire_bytes == 0
    assert cost.peak_live_bytes > cost.start_live_bytes > 0
    with op_cost.fake_mode() as mode:
        whole = S.state_specs(cfg, tcfg, make_mesh((1, 1), ("data", "model"), ["cpu"]),
                              mode=mode)
    total = sum(t.numel() * t.element_size() for t in leaves({k: v for k, v in whole.items()
                                                              if k != "step"}))
    assert total / 8 <= state_bytes < total  # sharded, never below an even split
    dcost, dbytes, _ = dryrun.count_program(cfg, tcfg, DECODE, mesh)
    assert dcost.flops > 0 and dbytes > 0


def test_count_cell_through_the_cli(tmp_path):
    """One record through the CLI, read back with the reference's keys that
    have a counterpart; a second call skips the existing cell."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-moe-3b-a800m",
           "--shape", "decode_32k", "--out", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "granite-moe-3b-a800m_decode_32k_card.json").read_text())
    for key in ("arch", "shape", "mesh", "num_devices", "params_total", "params_active",
                "preset", "count_s", "memory", "cost", "collectives",
                "collective_wire_bytes_per_device", "model_flops_total", "roofline"):
        assert key in rec, key
    assert {"peak_live_bytes_per_device", "fits_80GB"} <= set(rec["memory"])
    assert {"flops_per_device", "bytes_per_device"} <= set(rec["cost"])
    assert {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
            "useful_flops_fraction", "roofline_mfu"} <= set(rec["roofline"])
    assert rec["mesh"] == "card" and rec["card"] == "H100 SXM"
    assert rec["cost"]["flops_per_device"] > rec["model_flops_total"]  # + attention over 32K
    assert rec["collective_wire_bytes_per_device"] == 0.0
    again = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert again.returncode == 0 and "[skip]" in again.stdout


def test_reference_meshes_are_accounting_only():
    """On the reference's meshes a record gives state bytes a device from the
    specs and an even split of the one-card FLOPs, and no activation peak or
    wire bytes (they need one process a card)."""
    rec = dryrun.count_cell("granite-moe-3b-a800m", ShapeConfig("d", 64, 32, "decode"), "single")
    card = dryrun.count_cell("granite-moe-3b-a800m", ShapeConfig("d", 64, 32, "decode"), "card")
    assert rec["num_devices"] == 256
    assert rec["memory"]["peak_live_bytes_per_device"] is None
    assert rec["collective_wire_bytes_per_device"] is None and "ROADMAP item 4.7" in rec[
        "not_counted"]
    assert rec["cost"]["flops_per_device"] == pytest.approx(card["cost"]["flops_per_device"] / 256)
    assert rec["memory"]["state_bytes_per_device"] < card["memory"]["state_bytes_per_device"] / 8
    assert rec["roofline"]["t_collective_s"] is None


def test_hybrid_train_step_flops_match_the_reference_within_a_band():
    """jamba-v0.1-52b smoke (one period of 8 layers) at 4 x 64, one
    microbatch: within 1 %, not to the FLOP, because the Mamba scan's
    chunked einsums are the port's own (counted 0.17 % apart; the
    reference compiles in about 15 s, so the cell is small)."""
    ours = lm_train_cost("jamba-v0.1-52b", B=4, S=64, microbatches=1).flops
    theirs = jax_train_flops("jamba-v0.1-52b", B=4, S=64, microbatches=1)
    assert ours == pytest.approx(theirs, rel=0.01)
