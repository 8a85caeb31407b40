"""Partition rules: parameter path -> partition spec, and activation
constraints, as the reference's (``repro/models/sharding.py``).

Mesh axes: ``pod`` (inter-pod data parallelism), ``data`` (intra-pod data
parallelism / FSDP), ``model`` (tensor and expert parallelism).  FSDP
shards parameters over ("pod", "data"); TP shards heads, d_ff, vocab and
experts over "model".  A dimension that does not divide its axis's size
falls back to replication.  A spec is a tuple with one entry a dimension:
an axis name, a tuple of names, or None (the reference's
``PartitionSpec`` entries); :class:`NamedSharding` pairs it with its
:class:`~repro_torch.launch.mesh.Mesh`.

The port runs on one card, so nothing here moves a tensor:
:func:`constrain` returns its input, and :func:`dp_extent` and
:func:`seq_parallel_enabled` read the activation mesh
(:func:`use_activation_mesh`) only to keep the reference's arithmetic
(``models.moe.apply_moe`` rounds its group count up to the data-parallel
extent).  Paths are :func:`repro_torch.tree.flatten`'s, so the ResNet's
rules see the reference's names; its conv rule is stated for HWIO, the
layout of the reference and of checkpoint files.
"""
from __future__ import annotations

import re
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, NamedTuple, Optional, Sequence, Tuple

from repro_torch.tree import map_with_path

FSDP = "__fsdp__"  # placeholder resolved to the mesh's data axes
TP = "model"

# (regex on the /-joined param path) -> spec aligned to the LAST ndim dims.
# Leading (stacked) dims are padded with None.
_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    (r"embed/w$", (TP, FSDP)),
    (r"lm_head/w$", (FSDP, TP)),
    (r"pos_embed$", (None, None)),
    # attention (GQA/MHA)
    (r"w[qkv]$", (FSDP, TP, None)),
    (r"wo$", (TP, None, FSDP)),
    # MLA
    (r"wq_a$", (FSDP, None)),
    (r"wq_b$", (None, TP, None)),
    (r"wkv_a$", (FSDP, None)),
    (r"wk_rope$", (FSDP, None)),
    (r"wkv_b$", (None, TP, None)),
    # dense MLP
    (r"w_gate$", (FSDP, TP)),
    (r"w_up$", (FSDP, TP)),
    (r"w_down$", (TP, FSDP)),
    # MoE (leading E dim)
    (r"router$", (FSDP, None)),
    (r"moe/w_gate$", (TP, FSDP, None)),
    (r"moe/w_up$", (TP, FSDP, None)),
    (r"moe/w_down$", (TP, None, FSDP)),
    # mamba
    (r"in_proj$", (FSDP, TP)),
    (r"conv_w$", (None, TP)),
    (r"conv_b$", (TP,)),
    (r"x_proj$", (TP, None)),
    (r"dt_proj$", (None, TP)),
    (r"dt_bias$", (TP,)),
    (r"A_log$", (TP, None)),
    (r"(^|/)D$", (TP,)),
    (r"out_proj$", (TP, FSDP)),
    # rwkv6
    (r"w_[rkvg]$", (FSDP, TP, None)),
    (r"w_o$", (FSDP, TP)),
    (r"lora_a$", (FSDP, None)),
    (r"lora_b$", (None, TP, None)),
    (r"(w0|u|ln_scale|ln_bias)$", (TP, None)),
    (r"mu_[rkvwgx]$", (None,)),
    # rwkv channel-mix
    (r"cm/w_k$", (FSDP, TP)),
    (r"cm/w_v$", (TP, FSDP)),
    (r"cm/w_r$", (FSDP, None)),
    # resnet convs (HWIO): shard output channels on model
    (r"conv.*/w$", (None, None, None, TP)),
    (r"fc/w$", (FSDP, TP)),
    # norms / scalars / biases
    (r"(scale|bias|b)$", (None,)),
)


class NamedSharding(NamedTuple):
    mesh: Any
    spec: Tuple[Any, ...]


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh: Any, axis: Any) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _resolve(entry: Any, mesh: Any) -> Any:
    if entry == FSDP:
        ax = dp_axes(mesh)
        return ax if len(ax) > 1 else (ax[0] if ax else None)
    return entry


def spec_for_path(path: str, ndim: int, shape: Sequence[int], mesh: Any) -> Tuple[Any, ...]:
    """Match the rules; align to the trailing dims; drop non-divisible axes."""
    matched: Optional[Tuple[Any, ...]] = None
    for pat, spec in _RULES:
        if re.search(pat, path):
            matched = spec
            break
    if matched is None or len(matched) > ndim:
        return ()
    full = [None] * (ndim - len(matched)) + [_resolve(e, mesh) for e in matched]
    out = []
    for dim, ax in zip(shape, full):
        if ax is not None and dim % _axis_size(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return tuple(out)


def param_specs(shapes: Any, mesh: Any) -> Any:
    """A tree of leaves with ``.shape`` -> the tree of their specs."""
    return map_with_path(lambda p, x: spec_for_path(p, len(x.shape), tuple(x.shape), mesh),
                         shapes)


def partition_params(shapes: Any, mesh: Any) -> Any:
    """A tree of leaves with ``.shape`` -> the tree of their shardings."""
    return map_with_path(
        lambda p, x: NamedSharding(mesh, spec_for_path(p, len(x.shape), tuple(x.shape), mesh)),
        shapes)


def batch_sharding(mesh: Any, shape: Sequence[int]) -> NamedSharding:
    """Inputs: the batch dim sharded over the DP axes, the rest replicated.
    A batch dim that does not divide the DP extent falls back to
    replication, as the parameter rules do."""
    ax = dp_axes(mesh)
    lead = ax if len(ax) > 1 else (ax[0] if ax else None)
    if lead is not None and (not shape or shape[0] % _axis_size(mesh, lead) != 0):
        lead = None
    return NamedSharding(mesh, (lead, *([None] * (max(len(shape), 1) - 1))))


# ---------------------------------------------------------------------------
# Activation constraints (a context-var mesh keeps model code mesh-agnostic)
# ---------------------------------------------------------------------------

_ACT_MESH: ContextVar[Optional[Any]] = ContextVar("activation_mesh", default=None)
_SEQ_PARALLEL: ContextVar[bool] = ContextVar("seq_parallel", default=False)


@contextmanager
def use_activation_mesh(mesh: Optional[Any], seq_parallel: bool = False):
    tok = _ACT_MESH.set(mesh)
    tok2 = _SEQ_PARALLEL.set(seq_parallel)
    try:
        yield
    finally:
        _ACT_MESH.reset(tok)
        _SEQ_PARALLEL.reset(tok2)


def constrain(x: Any, *axes: Any) -> Any:
    """The reference's sharding constraint (axes entries "dp" | "tp" |
    None): on one card, ``x`` itself."""
    return x


def seq_parallel_enabled() -> bool:
    return _SEQ_PARALLEL.get() and _ACT_MESH.get() is not None


def dp_extent() -> int:
    """Total DP extent (pod*data) of the active mesh, 1 if none."""
    mesh = _ACT_MESH.get()
    if mesh is None:
        return 1
    return _axis_size(mesh, dp_axes(mesh)) if dp_axes(mesh) else 1


def tp_divides(n: int) -> bool:
    """Does a dim of size n shard evenly over the active mesh's model axis?
    True when no mesh is active."""
    mesh = _ACT_MESH.get()
    if mesh is None or TP not in mesh.axis_names:
        return True
    return n % mesh.shape[TP] == 0
