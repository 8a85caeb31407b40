"""Decoder-only LM assembly, dense and RWKV families (the reference's
``repro/models/transformer.py``).

Block parameters are stacked over layers as in the reference (each leaf of
``params["blocks"]`` has a leading ``num_layers`` axis whenever there is more
than one block; ``cfg.scan_layers`` changes nothing here), so the same tree
crosses between the packages.  The reference's ``lax.scan`` over blocks
becomes a Python loop over ``torch.unbind`` of the stacked leaves, done
once per forward (its backward stacks the layers' gradients in one pass,
where indexing ``w[i]`` per layer would allocate a zero tensor the size of
the whole stack for each layer).  ``cfg.remat`` checkpoints each block
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` with
``nothing_saveable`` does.

The port has ``forward_train``; prefill and decode (with the KV cache)
come with the serving slice, MoE, Mamba and MLA mixers with theirs.  The
RWKV time-mix runs the plain chunked scan on sequences longer than one
token, as the reference's; its ``wkv_impl`` hook (the WKV kernel) is
reached by calling ``rwkv6.apply_rwkv_timemix`` directly.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6
from repro_torch.models.layers import (
    Params,
    apply_attention,
    apply_embedding,
    apply_lm_head,
    apply_mlp,
    apply_norm,
    cross_entropy_loss,
    init_attention,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_norm,
)
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# layer-kind schedule
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Per layer: (mixer, ffn).  The port has the dense decoder, ("attn",
    "mlp") on every layer, and RWKV-6, ("rwkv", "rwkv_cm"); other families
    raise until their slice."""
    if cfg.family == "rwkv":
        return [("rwkv", "rwkv_cm")] * cfg.num_layers
    if cfg.family != "decoder":
        raise ValueError(f"the port's LM is the dense decoder or RWKV-6; "
                         f"{cfg.name} is {cfg.family!r}")
    if cfg.attention is None or cfg.attention.kind not in ("mha", "gqa"):
        kind = cfg.attention.kind if cfg.attention is not None else None
        raise ValueError(f"the port's LM has mha/gqa attention; {cfg.name} has {kind!r}")
    return [("attn", "mlp")] * cfg.num_layers


def period(cfg: ModelConfig) -> int:
    kinds = layer_kinds(cfg)
    for p in range(1, len(kinds) + 1):
        if len(kinds) % p == 0 and all(kinds[i] == kinds[i % p] for i in range(len(kinds))):
            return p
    return len(kinds)


def _stacked(cfg: ModelConfig) -> bool:
    """Whether block leaves carry a leading layer axis (the reference stacks
    with vmap whenever there is more than one block)."""
    return cfg.num_layers // period(cfg) > 1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(generator: torch.Generator, cfg: ModelConfig,
                   kind: Tuple[str, str]) -> Params:
    mixer, ffn = kind
    dev = generator.device
    p: Params = {"ln1": init_norm(cfg, dev), "ln2": init_norm(cfg, dev)}
    if mixer == "attn":
        p["attn"] = init_attention(generator, cfg)
    elif mixer == "rwkv":
        p["tm"] = rwkv6.init_rwkv_timemix(generator, cfg)
    if ffn == "mlp":
        p["mlp"] = init_mlp(generator, cfg)
    elif ffn == "rwkv_cm":
        p["cm"] = rwkv6.init_rwkv_channelmix(generator, cfg)
    return p


def _stack(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device: Union[str, torch.device] = "cuda") -> Params:
    """Parameters in the reference's tree: embed, blocks (stacked over
    layers), final_norm, lm_head.  Drawn from ``generator`` on its device
    (a CUDA generator draws a full-width model in moments) and moved to
    ``device``.  The draws differ from ``jax.random``'s: tests carry the
    reference's weights across with :func:`repro_torch.convert.lm_params_from_jax`."""
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)
    P_ = period(cfg)
    n_blocks = cfg.num_layers // P_
    params: Params = {"embed": init_embedding(generator, cfg)}

    def init_block() -> Params:
        return {f"sub{j}": _init_sublayer(generator, cfg, kinds[j]) for j in range(P_)}

    blocks = [init_block() for _ in range(n_blocks)]
    params["blocks"] = _stack(blocks) if _stacked(cfg) else blocks[0]
    del blocks
    params["final_norm"] = init_norm(cfg, generator.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_lm_head(generator, cfg)
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_sublayer(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: Tuple[str, str], *,
                    positions: torch.Tensor) -> torch.Tensor:
    mixer, ffn = kind
    h = apply_norm(p["ln1"], x, cfg)
    if mixer == "attn":
        out = apply_attention(p["attn"], h, cfg, positions=positions, causal=True)
    elif mixer == "rwkv":
        out, _ = rwkv6.apply_rwkv_timemix(p["tm"], h, cfg,
                                          scan_mode="chunk" if h.shape[1] > 1 else "seq")
    else:
        raise ValueError(mixer)
    x = x + out
    h = apply_norm(p["ln2"], x, cfg)
    if ffn == "mlp":
        out = apply_mlp(p["mlp"], h, cfg)
    elif ffn == "rwkv_cm":
        out, _ = rwkv6.apply_rwkv_channelmix(p["cm"], h, cfg)
    else:
        raise ValueError(ffn)
    return x + out


def _unbind(tree: Any) -> List[Any]:
    """Stacked tree -> one tree per layer (views; one unbind per leaf)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: per_key[k][i] for k in per_key} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _apply_blocks(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    kinds = layer_kinds(cfg)
    P_ = period(cfg)

    def block_fn(xc: torch.Tensor, bp: Params) -> torch.Tensor:
        for j in range(P_):
            xc = _apply_sublayer(bp[f"sub{j}"], xc, cfg, kinds[j], positions=positions)
        return xc

    blocks = _unbind(params["blocks"]) if _stacked(cfg) else [params["blocks"]]
    for bp in blocks:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(block_fn, x, bp, use_reentrant=False)
        else:
            x = block_fn(x, bp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)  # MoE aux loss: none here
    return x, aux


def forward_train(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss, aux_loss)."""
    x = apply_embedding(params["embed"], batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _apply_blocks(params, x, cfg, positions=positions)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = apply_lm_head(params.get("lm_head"), x, cfg, embed=params["embed"])
    return cross_entropy_loss(logits, batch["targets"]), aux
