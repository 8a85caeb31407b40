"""Fake-tensor stand-ins for every (arch x shape) cell (the counterpart of
the reference's ``repro/launch/specs.py``): shapes and dtypes with no
storage, so a 340 B-parameter train state costs no memory.

Each leaf is a fake tensor (``FakeTensorMode``) carrying a ``.sharding``
attribute, a :class:`~repro_torch.models.sharding.NamedSharding` from the
partition rules: what the reference's ``ShapeDtypeStruct`` carries.
``input_specs`` gives the model inputs; ``state_specs`` the train state
(parameters FSDP x TP, optimizer state inheriting its parameter's sharding
by shape, as the reference's); ``param_specs_only`` bf16 serving
parameters; ``cache_specs`` the KV / recurrent cache, batch over the
data-parallel axes and heads or features over "model", or its sequence
over "model" when the kv heads do not divide the axis (the reference's
context-parallel layout).

The port runs on one card: a sharding here is accounting (the dry run's
per-device state bytes on the reference's meshes), and nothing is placed.
Every function takes the ``FakeTensorMode`` its tensors belong to (one
mode for a whole cell, so a program can mix them).  The tensors are fake
CPU tensors: a program counted for the card runs them under
:func:`repro_torch.kernels.cost.for_card`.  The step, a host int in the
port's train state, has no spec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.op_cost import fake_mode
from repro_torch.models import encdec, transformer
from repro_torch.models.sharding import (
    NamedSharding,
    batch_sharding,
    dp_axes,
    partition_params,
)
from repro_torch.tree import flatten, tree_map


def _with_sharding(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    t.sharding = sharding
    return t


def _batch_tree(tree: Dict[str, torch.Tensor], mesh: Any) -> Dict[str, torch.Tensor]:
    return {k: _with_sharding(t, batch_sharding(mesh, tuple(t.shape))) for k, t in tree.items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any, *,
                mode=None) -> Dict[str, torch.Tensor]:
    """Model inputs for this cell: int32 tokens (and targets to train),
    bf16 encoder frames and patch embeddings where the arch takes them."""
    B, S = shape.global_batch, shape.seq_len
    with mode or fake_mode():
        if shape.kind == "decode":
            return _batch_tree({"tokens": torch.zeros((B, 1), dtype=torch.int32)}, mesh)
        specs = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
        if shape.kind == "train":
            specs["targets"] = torch.zeros((B, S), dtype=torch.int32)
        if cfg.family == "encdec":
            t_enc = cfg.encoder_seq_len or 1500
            fd = cfg.frontend_dim or cfg.d_model
            specs["frames"] = torch.zeros((B, t_enc, fd), dtype=torch.bfloat16)
        if cfg.num_patch_tokens:
            specs["patch_embeds"] = torch.zeros((B, cfg.num_patch_tokens, cfg.frontend_dim),
                                                dtype=torch.bfloat16)
        return _batch_tree(specs, mesh)


def _jax_order(tree: Any, path: Tuple = ()):
    """(path, leaf) in the reference's leaf order: dict keys sorted at each
    level (``/`` inside a key, as the ResNet's ``conv/w``, stays one key)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_order(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_order(v, path + (i,))
    else:
        yield path, tree


def _replicated(mesh: Any, t: torch.Tensor) -> NamedSharding:
    return NamedSharding(mesh, (None,) * t.dim())


def state_specs(cfg: ModelConfig, tcfg: TrainConfig, mesh: Any, *,
                mode=None) -> Dict[str, Any]:
    """The train state (``params``, ``opt``, ``ef`` with int8 compression)
    as sharded fake tensors; the step stays the host int 0.  An optimizer
    leaf takes the sharding of the first parameter (in the reference's leaf
    order) of its shape, and is replicated where no parameter has it."""
    from repro_torch.train.steps import init_resnet_train_state, init_train_state

    with mode or fake_mode():
        generator = torch.Generator()
        if cfg.family == "resnet":
            state = init_resnet_train_state(cfg, tcfg, generator, "cpu")
        else:
            state = init_train_state(cfg, tcfg, generator, "cpu")
    params = tree_map(_with_sharding, state["params"], partition_params(state["params"], mesh))
    by_shape: Dict[Tuple[int, ...], NamedSharding] = {}
    for _, leaf in _jax_order(params):
        by_shape.setdefault(tuple(leaf.shape), leaf.sharding)

    def opt_leaf(t: torch.Tensor) -> torch.Tensor:
        return _with_sharding(t, by_shape.get(tuple(t.shape)) or _replicated(mesh, t))

    out: Dict[str, Any] = {
        "params": params,
        "opt": tree_map(opt_leaf, state["opt"]),
        "step": state["step"],
    }
    if "bn" in state:
        out["bn"] = tree_map(lambda t: _with_sharding(t, _replicated(mesh, t)), state["bn"])
    if "ef" in state:
        out["ef"] = tree_map(_with_sharding, state["ef"], partition_params(state["ef"], mesh))
    return out


def param_specs_only(cfg: ModelConfig, mesh: Any, dtype: Optional[str] = "bfloat16", *,
                     mode=None) -> Any:
    """Serving parameters (bf16 by default) as sharded fake tensors."""
    scfg = dataclasses.replace(cfg, param_dtype=dtype or cfg.param_dtype)
    with mode or fake_mode():
        generator = torch.Generator()
        init = encdec.init_encdec if cfg.family == "encdec" else transformer.init_lm
        params = init(scfg, generator, "cpu")
    return tree_map(_with_sharding, params, partition_params(params, mesh))


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any, *, mode=None) -> Any:
    """The decode cache, sharded: batch over the DP axes, heads / latent /
    channel dims over "model" (a dim that does not divide stays whole), or
    the sequence over "model" when the kv heads do not divide it or the
    attention is MLA (absorbed decode reads its local slice)."""
    B, max_len = shape.global_batch, shape.seq_len
    with mode or fake_mode():
        if cfg.family == "encdec":
            cache = encdec.init_dec_cache(cfg, B, max_len, "cpu")
        else:
            cache = transformer.init_cache(cfg, B, max_len, "cpu")

    dp = dp_axes(mesh)
    dp_ax = dp if len(dp) > 1 else (dp[0] if dp else None)
    tp_size = mesh.shape.get("model", 1)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    t_enc = cfg.encoder_seq_len or 1500
    a = cfg.attention
    seq_cp = bool(a) and (a.kind == "mla" or a.num_kv_heads % max(tp_size, 1) != 0)

    def leaf(t: torch.Tensor) -> torch.Tensor:
        dims = list(t.shape)
        spec: list = [None] * len(dims)
        # batch axis: first dim of size B after dim 0 (the stacked-layer dim)
        b_idx = next((i for i, d in enumerate(dims) if d == B and i > 0), None)
        if b_idx is not None and dp_ax is not None and B % max(dp_size, 1) == 0:
            spec[b_idx] = dp_ax
        if seq_cp:
            for i in range(1 if len(dims) > 2 else 0, len(dims)):
                if i != b_idx and dims[i] in (max_len, t_enc) and dims[i] % tp_size == 0:
                    spec[i] = "model"
                    return _with_sharding(t, NamedSharding(mesh, tuple(spec)))
        # model axis: first feature dim (not layers / batch / sequence)
        for i in range(len(dims)):
            if i == 0 and len(dims) > 2:
                continue  # stacked-layer dim: never sharded
            if i == b_idx or dims[i] in (max_len, t_enc):
                continue  # sequence dims stay whole
            if spec[i] is None and dims[i] % tp_size == 0 and dims[i] >= tp_size:
                spec[i] = "model"
                break
        return _with_sharding(t, NamedSharding(mesh, tuple(spec)))

    return tree_map(leaf, cache)


def shard_bytes(tree: Any) -> int:
    """Bytes a device holds of a sharded tree: each leaf's bytes over the
    product of the mesh axes its spec names."""
    total = 0
    for t in flatten(tree).values():
        if not isinstance(t, torch.Tensor):
            continue
        sh = getattr(t, "sharding", None)
        parts = 1
        for entry in (sh.spec if sh is not None else ()):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    parts *= sh.mesh.shape[ax]
        total += t.numel() * t.element_size() // parts
    return total
