"""Dry run for the H100: count every (arch x shape x mesh) cell (the
counterpart of the reference's ``repro/launch/dryrun.py``).

For each cell the port's own program is built at full width and depth on
fake tensors (no card, no allocation) and run once under
:class:`~repro_torch.launch.op_cost.OpCounter`:

    train_4k     -> train_step   (fwd+bwd+optimizer, microbatch accumulation)
    prefill_32k  -> prefill      (writes the cache, last-token logits)
    decode_32k   -> decode_step  (1 new token against a seq_len cache)
    long_500k    -> decode_step  (SSM/hybrid archs only)

Mesh kinds:

- ``card`` (default): one H100, what the port runs.  The whole program is
  counted: FLOPs by compute class, bytes, the peak of live bytes against
  the card's HBM (``fits_80GB``), and the roofline.
- ``single`` (16, 16) and ``multi`` (2, 16, 16): the reference's meshes,
  as accounting only.  State bytes a device come from the partition specs
  (:mod:`repro_torch.launch.specs`); FLOPs and bytes are the one-card
  count split evenly over the devices (labelled so).  The activation peak
  and the collectives' wire bytes are ``null``: they need one process a
  card (ROADMAP item 4.7), and no number is made up for them.

Records go to ``reports/dryrun_torch/<arch>_<shape>_<mesh>[_<tag>].json``;
existing cells are skipped (``--force`` recounts).  ``--all`` runs every
cell of ``configs.ASSIGNED``, each (arch, shape) in a subprocess of its
own.  Counting is host time: about a minute for granite-8b train_4k.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh all] [--out reports/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig, TrainConfig, arch_shapes, get_arch
from repro_torch.configs import ASSIGNED
from repro_torch.kernels.cost import for_card
from repro_torch.launch import op_cost
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.roofline import DEFAULT_CARD, Roofline, card_peaks
from repro_torch.models import encdec, transformer
from repro_torch.models.counting import count_active_params, count_params
from repro_torch.models.sharding import use_activation_mesh
from repro_torch.train.steps import make_train_step

# Per-arch fit presets: optimizer + grad-accumulation + sequence-parallel
# (the reference's, verbatim).
FIT_PRESETS: Dict[str, Dict[str, Any]] = {
    "nemotron-4-340b": dict(optimizer="adafactor", microbatches=16, seq_parallel=True),
    "jamba-v0.1-52b": dict(optimizer="adafactor", microbatches=16, seq_parallel=False),
    "internvl2-26b": dict(optimizer="adafactor", microbatches=16, seq_parallel=False),
    "granite-3-8b": dict(optimizer="adamw", microbatches=8, seq_parallel=False),
    "granite-8b": dict(optimizer="adamw", microbatches=4, seq_parallel=False),
    "minicpm3-4b": dict(optimizer="adamw", microbatches=8, seq_parallel=False),
    "qwen2-moe-a2.7b": dict(optimizer="adamw", microbatches=8, seq_parallel=False),
    "granite-moe-3b-a800m": dict(optimizer="adamw", microbatches=4, seq_parallel=False),
    "rwkv6-7b": dict(optimizer="adamw", microbatches=4, seq_parallel=False),
    "whisper-large-v3": dict(optimizer="adamw", microbatches=8, seq_parallel=False),
}

MESHES: Dict[str, Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]] = {
    "card": None,
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}
MESH_CHOICES = {"card": ["card"], "single": ["single"], "multi": ["multi"],
                "both": ["single", "multi"], "all": ["card", "single", "multi"]}
NOT_COUNTED = "needs one process a card (ROADMAP item 4.7)"
EVEN_SPLIT = "the one-card count split evenly over the mesh's devices"


def make_programs(cfg: ModelConfig, tcfg: TrainConfig) -> Dict[str, Any]:
    model = encdec if cfg.family == "encdec" else transformer
    return {
        "train": make_train_step(cfg, tcfg),
        "prefill": lambda p, b, c: model.prefill(p, b, cfg, c),
        "decode": lambda p, c, t, pos: model.decode_step(p, c, t, pos, cfg),
    }


def cell_config(arch: str, overrides: Optional[Dict[str, Any]] = None):
    """(cfg, tcfg, seq_parallel) of a cell: the arch's fit preset with
    ``overrides`` applied, as the reference's ``lower_cell`` derives them."""
    cfg = get_arch(arch)
    preset = dict(FIT_PRESETS.get(arch, {}))
    preset.update(overrides or {})
    seq_parallel = preset.pop("seq_parallel", False)
    remat = preset.pop("remat", None)
    scan_layers = preset.pop("scan_layers", None)
    moe_dispatch = preset.pop("moe_dispatch", None)
    moe_group_size = preset.pop("moe_group_size", None)
    num_layers = preset.pop("num_layers", None)  # a depth cut, counted at full width
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if scan_layers is not None:
        cfg = dataclasses.replace(cfg, scan_layers=scan_layers)
    if cfg.moe is not None and (moe_dispatch or moe_group_size):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=moe_dispatch or cfg.moe.dispatch,
            group_size=moe_group_size or cfg.moe.group_size))
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in preset.items() if k in fields})
    return cfg, tcfg, seq_parallel


def cell_mesh(kind: str) -> Optional[Mesh]:
    """The reference's mesh of ``kind`` over stand-in devices (accounting:
    nothing is placed), or None for one card."""
    if MESHES[kind] is None:
        return None
    shape, axes = MESHES[kind]
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, axes, ["cpu"] * n)


def _dp(mesh: Optional[Mesh]) -> int:
    n = 1
    for a in ("pod", "data"):
        if mesh is not None and a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def _cell_args(cfg: ModelConfig, tcfg: TrainConfig, shape: ShapeConfig, mesh: Mesh, mode):
    """(the program's arguments, the trees a device holds) of a cell, as
    sharded fake tensors on ``mesh``."""
    kw = dict(mode=mode)
    if shape.kind == "train":
        state = S.state_specs(cfg, tcfg, mesh, **kw)
        return (state, S.input_specs(cfg, shape, mesh, **kw)), \
            {k: v for k, v in state.items() if k != "step"}
    params = S.param_specs_only(cfg, mesh, **kw)
    cache = S.cache_specs(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return (params, S.input_specs(cfg, shape, mesh, **kw), cache), (params, cache)
    toks = S.input_specs(cfg, shape, mesh, **kw)["tokens"]
    return (params, cache, toks, shape.seq_len - 1), (params, cache)


def _one_card() -> Mesh:
    return make_mesh((1, 1), ("data", "model"), ["cpu"])


def state_bytes_of(cfg: ModelConfig, tcfg: TrainConfig, shape: ShapeConfig,
                   mesh: Optional[Mesh]) -> int:
    """Bytes a device of ``mesh`` (one card for None) holds of the cell's
    state, cache and parameters, from the partition specs."""
    return S.shard_bytes(_cell_args(cfg, tcfg, shape, mesh or _one_card(),
                                    op_cost.fake_mode())[1])


def count_program(cfg: ModelConfig, tcfg: TrainConfig, shape: ShapeConfig,
                  mesh: Optional[Mesh], seq_parallel: bool = False):
    """Build the cell's program on fake tensors and count one run; returns
    (cost, state bytes a device, seconds).  ``mesh`` (None for one card)
    sets the activation mesh, as the reference lowers under it, and the
    specs' shardings."""
    mode = op_cost.fake_mode()
    program = make_programs(cfg, tcfg)[shape.kind]
    t0 = time.perf_counter()
    args, held = _cell_args(cfg, tcfg, shape, mesh or _one_card(), mode)
    with mode, use_activation_mesh(mesh, seq_parallel=seq_parallel), for_card():
        _, cost = op_cost.count(program, *args)
    return cost, S.shard_bytes(held), time.perf_counter() - t0


_COUNTS: Dict[Any, Tuple[Any, int, float]] = {}


def model_flops_of(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N D (train), 2 N D (prefill) or 2 N B (decode: one token a row),
    N the active parameters, as the reference's."""
    n = count_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def count_cell(arch: str, shape: ShapeConfig, mesh_kind: str = "card", *,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Count one cell; returns its record (the reference's keys where they
    have a counterpart)."""
    cfg, tcfg, seq_parallel = cell_config(arch, overrides)
    mesh = cell_mesh(mesh_kind)
    if shape.kind == "train":
        # the per-microbatch batch must stay shardable over the DP extent
        mb_max = max(shape.global_batch // _dp(mesh), 1)
        if tcfg.microbatches > mb_max:
            tcfg = dataclasses.replace(tcfg, microbatches=mb_max)
    card = card_peaks(DEFAULT_CARD)
    # one count serves every mesh kind whose program is the same: the same
    # microbatches and, for an MoE, the DP extent its groups round up to
    key = (cfg, tcfg, shape, _dp(mesh) if cfg.moe is not None else 1, seq_parallel)
    if key in _COUNTS:
        cost, count_s = _COUNTS[key][0], _COUNTS[key][2]
        state_bytes = state_bytes_of(cfg, tcfg, shape, mesh)
    else:
        cost, state_bytes, count_s = _COUNTS[key] = count_program(cfg, tcfg, shape, mesh,
                                                                  seq_parallel)
    n_dev = mesh.size if mesh is not None else 1
    model_flops = model_flops_of(cfg, shape)
    per_dev = {c: f / n_dev for c, f in cost.flops_by_class.items()}
    counted = mesh is None
    roof = Roofline(per_dev, cost.traffic_bytes / n_dev,
                    cost.wire_bytes if counted else None, model_flops, n_dev, card)
    peak = cost.peak_live_bytes if counted else None
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind, "num_devices": n_dev,
        "card": card.name,
        "params_total": count_params(cfg), "params_active": count_active_params(cfg),
        "preset": {**FIT_PRESETS.get(arch, {}), **(overrides or {})},
        "microbatches": tcfg.microbatches,
        "count_s": round(count_s, 2),
        "memory": {
            "state_bytes_per_device": state_bytes,
            "state_fits_80GB": bool(state_bytes < card.hbm_bytes),
            "start_live_bytes": cost.start_live_bytes if counted else None,
            "peak_live_bytes_per_device": peak,
            "fits_80GB": bool(peak < card.hbm_bytes) if counted else None,
            "hbm_bytes": card.hbm_bytes,
        },
        "cost": {
            "flops_per_device": cost.flops / n_dev,
            "bytes_per_device": cost.traffic_bytes / n_dev,
            "flops_by_class": per_dev,
            **({} if counted else {"split": EVEN_SPLIT}),
            "ops": cost.ops, "kernels": cost.kernels, "flags": cost.flags,
            "top_flops": cost.top_flops, "top_bytes": cost.top_bytes,
        },
        "collectives": ({k: {"count": cost.coll_count.get(k, 0),
                             "wire_bytes": cost.wire_by_kind.get(k, 0.0)}
                         for k in sorted(cost.wire_by_kind)} if counted else None),
        "collective_wire_bytes_per_device": cost.wire_bytes if counted else None,
        "model_flops_total": model_flops,
        "model_flops_ratio": cost.flops / model_flops if model_flops else None,
        "roofline": roof.row(),
    }
    if not counted:
        record["not_counted"] = f"collectives and activation peak {NOT_COUNTED}"
    return record


def cell_list(mesh_kinds: List[str]) -> List[Tuple[str, str, str]]:
    return [(arch, shape.name, mk) for arch in ASSIGNED
            for shape in arch_shapes(get_arch(arch)) for mk in mesh_kinds]


def _path(out: str, arch: str, shape: str, mesh: str, tag: str) -> str:
    return os.path.join(out, f"{arch}_{shape}_{mesh}{f'_{tag}' if tag else ''}.json")


def _parse_overrides(text: str) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        overrides[k] = v == "true" if v in ("true", "false") else int(v) if v.isdigit() else v
    return overrides


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESH_CHOICES), default="card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for experiment variants")
    ap.add_argument("--override", default="", help="k=v[,k=v] preset overrides: TrainConfig "
                    "fields, seq_parallel, remat, scan_layers, moe_dispatch, moe_group_size, "
                    "num_layers (a depth cut)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    mesh_kinds = MESH_CHOICES[args.mesh]

    if args.all:  # each (arch, shape) in a process of its own
        failures = 0
        for arch, shape in dict.fromkeys((a, sh) for a, sh, _ in cell_list(mesh_kinds)):
            if not args.force and all(os.path.exists(_path(args.out, arch, shape, mk, args.tag))
                                      for mk in mesh_kinds):
                print(f"[skip] {arch} x {shape}", flush=True)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", args.mesh, "--out", args.out, "--tag", args.tag,
                   "--override", args.override]
            failures += subprocess.call(cmd + (["--force"] if args.force else [])) != 0
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    failures = 0
    for mk in mesh_kinds:
        path = _path(args.out, args.arch, args.shape, mk, args.tag)
        if os.path.exists(path) and not args.force:
            print(f"[skip] {path}", flush=True)
            continue
        print(f"[cell] {args.arch} x {args.shape} x {mk} ...", flush=True)
        try:
            rec = count_cell(args.arch, SHAPES[args.shape], mk,
                             overrides=_parse_overrides(args.override))
        except Exception as e:  # a cell that cannot be counted says why
            failures += 1
            print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            continue
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        r, m = rec["roofline"], rec["memory"]
        mem = m["peak_live_bytes_per_device"]
        mem = m["state_bytes_per_device"] if mem is None else mem
        print(f"  ok: count {rec['count_s']}s, mem/dev {mem / 2**30:.2f} GiB"
              f"{'' if m['peak_live_bytes_per_device'] is not None else ' (state only)'}, "
              f"flops/model {rec['model_flops_ratio']:.3f}, dominant={r['dominant']}, "
              f"mfu_bound={r['roofline_mfu']:.3f}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
