"""Whisper-style encoder-decoder (the reference's ``repro/models/encdec.py``).

The conv audio frontend is a stub, as in the reference: inputs are
precomputed frame embeddings (B, T_enc, frontend_dim or d_model), projected
by ``frontend_proj`` when ``frontend_dim`` differs from ``d_model``.  The
encoder is a bidirectional self-attention stack; a decoder layer is causal
self-attention, cross-attention over the encoder's K/V and a GELU MLP.
Positions are sinusoidal (no RoPE).

Layers stay stacked on a leading L axis (``enc_layers``, ``dec_layers``), as
the reference's ``jax.vmap`` lays them out, so its tree crosses leaf for
leaf with :func:`repro_torch.convert.from_jax`.  The reference's
``lax.scan`` over layers is a loop over views of the stacked leaves
(:func:`repro_torch.tree.unbind`), and ``cfg.remat`` checkpoints each
encoder and each decoder layer (``torch.utils.checkpoint``, non-reentrant),
as ``jax.checkpoint`` with ``nothing_saveable`` does to its layer body.

Attention routes as the reference's: the encoder's self-attention and the
cross-attention run ``_sdpa``'s plain route (non-causal), and the decoder's
cacheless self-attention takes ``cfg.attention_impl``, so ``"pallas"``
launches the flash kernel once a decoder layer in :func:`forward_train`
and never in :func:`prefill` or :func:`decode_step`, which attend over a
cache.  Training computes each layer's cross K/V inside its checkpointed
body, so only the encoder's output is kept for the backward.

Cross-attention K/V are computed once from the encoder output at prefill
and kept in the cache (``cross_k``, ``cross_v``, in the compute dtype);
decode never runs the encoder again.  :func:`decode_step` takes ``pos`` as
an int or as a (B,) array of host ints, one a slot, as
``transformer.decode_step`` does: each row gets its own sinusoidal row,
cache write and causal offset.  The reference's ``decode_step`` serves an
int only (a (B,) position fails to broadcast in its
``sinusoidal_embedding_at``, and its causal offset is row 0's), so its
engine serves one slot; the port's serves any number.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    Offset,
    Params,
    _sdpa,
    apply_attention,
    apply_embedding,
    apply_lm_head,
    apply_mlp,
    apply_norm,
    cdtype,
    cross_entropy_loss,
    dense_init,
    init_attention,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_norm,
    pdtype,
    sinusoidal_embedding,
    sinusoidal_embedding_at,
)
from repro_torch.tree import stack_init, tree_map, unbind


def _init_enc_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    return {"ln1": init_norm(cfg, dev), "attn": init_attention(generator, cfg),
            "ln2": init_norm(cfg, dev), "mlp": init_mlp(generator, cfg)}


def _init_dec_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    return {"ln1": init_norm(cfg, dev), "self_attn": init_attention(generator, cfg),
            "ln2": init_norm(cfg, dev),
            "cross_attn": init_attention(generator, cfg),  # self-attention's shapes
            "ln3": init_norm(cfg, dev), "mlp": init_mlp(generator, cfg)}


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Parameters in the reference's tree: embed, enc_layers and dec_layers
    (stacked over layers), enc_norm, final_norm, lm_head, and
    ``frontend_proj`` when ``frontend_dim`` is set and differs from
    ``d_model``.  Drawn from ``generator`` on its device and moved to
    ``device``; the draws differ from ``jax.random``'s (tests carry the
    reference's weights across with :func:`repro_torch.convert.from_jax`)."""
    dev = resolve_device(device)
    n_enc = cfg.num_encoder_layers or cfg.num_layers
    params: Params = {
        "embed": init_embedding(generator, cfg),
        "enc_layers": stack_init(n_enc, lambda: _init_enc_layer(generator, cfg)),
        "enc_norm": init_norm(cfg, generator.device),
        "dec_layers": stack_init(cfg.num_layers, lambda: _init_dec_layer(generator, cfg)),
        "final_norm": init_norm(cfg, generator.device),
        "lm_head": init_lm_head(generator, cfg),
    }
    if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
        params["frontend_proj"] = {
            "w": dense_init(generator, cfg.frontend_dim, (cfg.d_model,), pdtype(cfg))}
    return tree_map(lambda t: t.to(dev), params)


def _layer(body, cfg: ModelConfig, *args: Any) -> torch.Tensor:
    """One layer's body, checkpointed under ``cfg.remat`` while training."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _cross_attn(p: Params, h: torch.Tensor, kv: Params, cfg: ModelConfig) -> torch.Tensor:
    """Decoder query against precomputed encoder K/V (B, T_enc, Hkv, hd)."""
    a = cfg.attention
    B, S, _ = h.shape
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    qg = q.reshape(B, S, a.num_kv_heads, a.q_heads_per_kv, a.head_dim)
    out = _sdpa(qg, kv["k"].to(h.dtype), kv["v"].to(h.dtype), causal=False, q_offset=0)
    out = out.reshape(B, S, a.num_heads, a.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(h.dtype))


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, T_enc, frontend_dim) precomputed (the frontend stub)."""
    x = frames.to(cdtype(cfg))
    if "frontend_proj" in params:
        x = torch.einsum("bte,ed->btd", x, params["frontend_proj"]["w"].to(x.dtype))
    x = x + sinusoidal_embedding(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(x.shape[1], device=x.device)

    def body(xc: torch.Tensor, lp: Params) -> torch.Tensor:
        h = apply_norm(lp["ln1"], xc, cfg)
        out, _ = apply_attention(lp["attn"], h, cfg, positions=positions, causal=False)
        xc = xc + out
        h = apply_norm(lp["ln2"], xc, cfg)
        return xc + apply_mlp(lp["mlp"], h, cfg)

    for lp in unbind(params["enc_layers"]):
        x = _layer(body, cfg, x, lp)
    return apply_norm(params["enc_norm"], x, cfg)


def _cross_kv(lp: Params, enc: torch.Tensor, cfg: ModelConfig) -> Params:
    """One decoder layer's cross K/V of the encoder output, (B, T_enc, Hkv, hd)."""
    k = torch.einsum("btd,dhk->bthk", enc, lp["cross_attn"]["wk"].to(enc.dtype))
    v = torch.einsum("btd,dhk->bthk", enc, lp["cross_attn"]["wv"].to(enc.dtype))
    return {"k": k, "v": v}


def _decoder(params: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, *,
             enc: Optional[torch.Tensor] = None, cache: Optional[Params] = None,
             cache_pos: Optional[Offset] = None) -> torch.Tensor:
    """Every decoder layer.  Without a cache each layer's cross K/V come
    from ``enc`` (inside the checkpointed body); with one, from the cache's
    ``cross_k``/``cross_v``, and the self-attention K/V are written into
    its ``k``/``v`` in place, layer by layer through views of the stacked
    leaves."""

    def body(xc: torch.Tensor, lp: Params, enc_: Optional[torch.Tensor],
             lc: Optional[Params]) -> torch.Tensor:
        h = apply_norm(lp["ln1"], xc, cfg)
        self_cache = None if lc is None else {"k": lc["k"], "v": lc["v"]}
        out, _ = apply_attention(lp["self_attn"], h, cfg, positions=positions, causal=True,
                                 cache=self_cache, cache_pos=cache_pos)
        xc = xc + out
        h = apply_norm(lp["ln2"], xc, cfg)
        ckv = _cross_kv(lp, enc_, cfg) if lc is None else \
            {"k": lc["cross_k"], "v": lc["cross_v"]}
        xc = xc + _cross_attn(lp["cross_attn"], h, ckv, cfg)
        h = apply_norm(lp["ln3"], xc, cfg)
        return xc + apply_mlp(lp["mlp"], h, cfg)

    layers = unbind(params["dec_layers"])
    caches = [None] * len(layers) if cache is None else unbind(cache)
    for lp, lc in zip(layers, caches):
        x = _layer(body, cfg, x, lp, enc, lc)
    return x


def _with_positions(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings plus the sinusoidal rows of positions [0, S)."""
    x = apply_embedding(params["embed"], tokens, cfg)
    return x + sinusoidal_embedding(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]


def forward_train(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss, aux_loss); aux is zero (no MoE), as the reference's."""
    enc = encode(params, batch["frames"], cfg)
    x = _with_positions(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _decoder(params, x, cfg, positions, enc=enc)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = apply_lm_head(params["lm_head"], x, cfg)
    return (cross_entropy_loss(logits, batch["targets"]),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_dec_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: Union[str, torch.device] = "cuda") -> Params:
    """Zeros in the reference's tree, each leaf (L, B, ..., Hkv, hd) in the
    compute dtype: the self-attention ``k``, ``v`` of ``max_len`` positions
    and the cross ``cross_k``, ``cross_v`` of ``encoder_seq_len`` (1500 when
    unset) frames."""
    dev = resolve_device(device)
    a = cfg.attention
    L, t_enc = cfg.num_layers, cfg.encoder_seq_len or 1500

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros((L, batch, n, a.num_kv_heads, a.head_dim), dtype=cdtype(cfg),
                           device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "cross_k": zeros(t_enc), "cross_v": zeros(t_enc)}


def _last_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return apply_lm_head(params["lm_head"], x, cfg)[:, 0]


@torch.inference_mode()
def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Encodes ``batch["frames"]``, writes every layer's cross K/V into the
    cache and positions [0, S) of ``batch["tokens"]`` into its self-attention
    K/V, in place; returns (last-position logits, cache)."""
    enc = encode(params, batch["frames"], cfg)
    for i, lp in enumerate(unbind(params["dec_layers"])):
        kv = _cross_kv(lp, enc, cfg)
        cache["cross_k"][i].copy_(kv["k"])
        cache["cross_v"][i].copy_(kv["v"])
    del enc
    x = _with_positions(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _decoder(params, x, cfg, positions, cache=cache, cache_pos=0)
    return _last_logits(params, x, cfg), cache


@torch.inference_mode()
def decode_step(params: Params, cache: Params, tokens: torch.Tensor, pos: Any,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One token a row, ``tokens`` (B, 1), written at ``pos``: an int for
    every row, or a (B,) array of host ints, one a slot (continuous
    batching).  Host positions are checked against the cache's length here
    and cross to the device once a call.  Returns (logits (B, V), cache)."""
    dev = tokens.device
    if getattr(pos, "ndim", 0) == 0:
        cache_pos: Offset = int(pos)
        positions = torch.arange(cache_pos, cache_pos + 1, device=dev)
        rows = torch.tensor([cache_pos], device=dev)  # (1,): one row for every slot
    else:
        host = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos)
        limit = cache["k"].shape[2]
        if host.min() < 0 or host.max() >= limit:
            raise ValueError(f"decode positions {host.tolist()} outside a cache of {limit}")
        cache_pos = rows = torch.tensor(host, dtype=torch.long, device=dev)
        positions = cache_pos[:, None]  # (B, 1)
    x = apply_embedding(params["embed"], tokens, cfg)
    x = x + sinusoidal_embedding_at(rows, cfg.d_model).to(x.dtype)[:, None]
    x = _decoder(params, x, cfg, positions, cache=cache, cache_pos=cache_pos)
    return _last_logits(params, x, cfg), cache

