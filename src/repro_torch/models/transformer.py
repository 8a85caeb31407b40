"""Decoder-only LM assembly: the dense, MLA, MoE, RWKV and hybrid (jamba:
Mamba-1 and attention mixers, dense and MoE FFNs) families (the reference's
``repro/models/transformer.py``).

Layers run in *period blocks*, as the reference's: a homogeneous model has
period 1, jamba period 8 (7 Mamba mixers and 1 attention mixer at
``hybrid_attn_index``, dense and MoE FFNs alternating), one block holding
``sub0`` .. ``sub{period-1}``.  Block parameters are stacked over blocks as
in the reference (each leaf of ``params["blocks"]`` has a leading
``num_layers // period`` axis whenever there is more than one block;
``cfg.scan_layers`` changes nothing here), so the same tree crosses between
the packages.  The reference's ``lax.scan`` over blocks
becomes a Python loop over ``torch.unbind`` of the stacked leaves, done
once per forward (its backward stacks the layers' gradients in one pass,
where indexing ``w[i]`` per layer would allocate a zero tensor the size of
the whole stack for each layer).  ``cfg.remat`` checkpoints each block
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` with
``nothing_saveable`` does.

Three programs, as the reference's:

* ``forward_train`` — full-sequence causal forward, returns (loss, aux).
* ``prefill`` — writes positions [0, S) into the cache (chunked above
  ``PREFILL_CHUNK`` tokens), returns the last position's logits.
* ``decode_step`` — one token a row against the cache, at one position for
  every row or one per row (continuous batching).

The cache (``init_cache``) has the reference's tree and layout, so it
crosses with :func:`repro_torch.convert.from_jax`.  Where the reference
returns a new cache, the port writes the pooled tensors in place and
returns them.  Prefill and decode run under ``torch.inference_mode``.
An MLA layer caches its latent and rope key (``c_kv``, ``k_rope``); a Mamba
layer its conv window and SSM state (``conv``, ``ssm``, fp32); an MoE FFN
returns its load-balancing loss, summed over layers into ``aux``.
The VLM stub (internvl2-26b) is a decoder whose first ``num_patch_tokens``
positions take projected precomputed patch embeddings (``patch_proj``,
``_embed_inputs``), masked out of the loss; its prompt is never chunked.
The encoder-decoder is :mod:`repro_torch.models.encdec`.  The RWKV time-mix runs the
plain chunked scan on sequences longer than one token and the plain loop on
one, as the reference's; its ``wkv_impl`` hook (the WKV kernel) is reached
by calling ``rwkv6.apply_rwkv_timemix`` directly.  The Mamba scan is plain
PyTorch, chunked over time (:mod:`repro_torch.models.ssm`), as the
reference's is outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6, ssm
from repro_torch.models.layers import (
    Offset,
    Params,
    apply_attention,
    apply_embedding,
    apply_lm_head,
    apply_mla_attention,
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
)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.tree import flatten, stack_init, tree_map, unbind

# ---------------------------------------------------------------------------
# layer-kind schedule
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Per layer: (mixer, ffn) with mixer in {attn, mla, mamba, rwkv} and
    ffn in {mlp, moe, rwkv_cm}, the reference's schedule: RWKV-6 has
    ("rwkv", "rwkv_cm"); with ``hybrid_attn_period`` the mixer is "attn"
    where ``l % period == hybrid_attn_index`` and "mamba" elsewhere, else
    "mla" or "attn" (mha/gqa); the FFN is "moe" (where ``l % moe_every_k
    == 1`` when that is set) or "mlp".  The VLM stub is a decoder; the
    encoder-decoder (:mod:`repro_torch.models.encdec`) raises here."""
    if cfg.family not in ("decoder", "rwkv", "hybrid"):
        raise ValueError(f"the port's LM is the decoder, RWKV-6 or the hybrid; "
                         f"{cfg.name} is {cfg.family!r}")
    if cfg.family == "rwkv":
        return [("rwkv", "rwkv_cm")] * cfg.num_layers
    kinds = ("mha", "gqa") if cfg.hybrid_attn_period else ("mha", "gqa", "mla")
    if cfg.attention is None or cfg.attention.kind not in kinds:
        kind = cfg.attention.kind if cfg.attention is not None else None
        raise ValueError(f"the port's {cfg.family} has {'/'.join(kinds)} attention; "
                         f"{cfg.name} has {kind!r}")
    out = []
    for l in range(cfg.num_layers):  # noqa: E741
        if cfg.hybrid_attn_period:
            mixer = "attn" if l % cfg.hybrid_attn_period == cfg.hybrid_attn_index else "mamba"
        else:
            mixer = "mla" if cfg.attention.kind == "mla" else "attn"
        if cfg.moe is None:
            ffn = "mlp"
        elif cfg.moe_every_k:
            ffn = "moe" if l % cfg.moe_every_k == 1 else "mlp"
        else:
            ffn = "moe"
        out.append((mixer, ffn))
    return out


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
    if mixer in ("attn", "mla"):
        p["attn"] = init_attention(generator, cfg)
    elif mixer == "mamba":
        p["mamba"] = ssm.init_mamba(generator, cfg)
    elif mixer == "rwkv":
        p["tm"] = rwkv6.init_rwkv_timemix(generator, cfg)
    if ffn == "mlp":
        p["mlp"] = init_mlp(generator, cfg)
    elif ffn == "moe":
        p["moe"] = init_moe(generator, cfg)
    elif ffn == "rwkv_cm":
        p["cm"] = rwkv6.init_rwkv_channelmix(generator, cfg)
    return p


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

    params["blocks"] = stack_init(n_blocks, init_block) if _stacked(cfg) else init_block()
    params["final_norm"] = init_norm(cfg, generator.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_lm_head(generator, cfg)
    if cfg.num_patch_tokens and cfg.frontend_dim:
        params["patch_proj"] = {
            "w": dense_init(generator, cfg.frontend_dim, (cfg.d_model,), pdtype(cfg))}
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _sublayer_cache(cfg: ModelConfig, kind: Tuple[str, str], batch: int, max_len: int,
                    device: torch.device) -> Params:
    mixer, _ = kind
    a = cfg.attention
    if mixer == "attn":
        shape = (batch, max_len, a.num_kv_heads, a.head_dim)
        return {"k": torch.zeros(shape, dtype=cdtype(cfg), device=device),
                "v": torch.zeros(shape, dtype=cdtype(cfg), device=device)}
    if mixer == "mla":
        return {"c_kv": torch.zeros((batch, max_len, a.kv_lora_rank), dtype=cdtype(cfg),
                                    device=device),
                "k_rope": torch.zeros((batch, max_len, a.qk_rope_head_dim), dtype=cdtype(cfg),
                                      device=device)}
    if mixer == "mamba":
        return ssm.init_mamba_cache(cfg, batch, device)
    if mixer == "rwkv":
        return rwkv6.init_rwkv_cache(cfg, batch, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> Params:
    """Zeros in the reference's tree: ``{"sub0": {"k", "v"}}`` of (B,
    max_len, Hkv, D) in the compute dtype for attention, ``{"c_kv",
    "k_rope"}`` of (B, max_len, kv_lora_rank) and (B, max_len,
    qk_rope_head_dim) for MLA, Mamba's ``{"conv", "ssm"}`` of (B, d_conv - 1,
    d_inner) and (B, d_inner, d_state) and RWKV's state and token shifts in
    fp32; each leaf with a leading block axis when blocks are stacked."""
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)
    P_ = period(cfg)
    one = {f"sub{j}": _sublayer_cache(cfg, kinds[j], batch, max_len, dev) for j in range(P_)}
    if not _stacked(cfg):
        return one
    n_blocks = cfg.num_layers // P_
    return tree_map(lambda t: torch.zeros((n_blocks, *t.shape), dtype=t.dtype, device=dev), one)


def _cache_len(cache: Params) -> Optional[int]:
    """Positions an attention cache holds: the length axis of a ``k``
    (B, max_len, Hkv, D) or an MLA ``c_kv`` (B, max_len, r) leaf; None for a
    recurrent cache."""
    for path, leaf in flatten(cache).items():
        if path.endswith("/k"):
            return leaf.shape[-3]
        if path.endswith("/c_kv"):
            return leaf.shape[-2]
    return None


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_sublayer(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: Tuple[str, str], *,
                    positions: torch.Tensor, cache: Optional[Params] = None,
                    cache_pos: Optional[Offset] = None
                    ) -> Tuple[torch.Tensor, Optional[Params], Optional[torch.Tensor]]:
    """One layer; returns (x, the layer's new cache, or None without one,
    the MoE aux loss, or None for another FFN: a dense layer adds no
    kernel for it)."""
    mixer, ffn = kind
    aux = None
    h = apply_norm(p["ln1"], x, cfg)
    new_cache = cache
    if mixer == "attn":
        out, new_cache = apply_attention(p["attn"], h, cfg, positions=positions, causal=True,
                                         cache=cache, cache_pos=cache_pos)
    elif mixer == "mla":
        out, new_cache = apply_mla_attention(p["attn"], h, cfg, positions=positions,
                                             causal=True, cache=cache, cache_pos=cache_pos)
    elif mixer == "mamba":
        out, new_cache = ssm.apply_mamba(p["mamba"], h, cfg, cache=cache)
    elif mixer == "rwkv":
        out, tm_cache = rwkv6.apply_rwkv_timemix(p["tm"], h, cfg, cache=cache,
                                                 scan_mode="chunk" if h.shape[1] > 1 else "seq")
        if tm_cache is not None:
            new_cache = dict(cache, **tm_cache)
    else:
        raise ValueError(mixer)
    x = x + out
    h = apply_norm(p["ln2"], x, cfg)
    if ffn == "mlp":
        out = apply_mlp(p["mlp"], h, cfg)
    elif ffn == "moe":
        out, aux = apply_moe(p["moe"], h, cfg)
    elif ffn == "rwkv_cm":
        out, cm_cache = rwkv6.apply_rwkv_channelmix(p["cm"], h, cfg, cache=new_cache)
        if cm_cache is not None:
            new_cache = dict(new_cache, **cm_cache)
    else:
        raise ValueError(ffn)
    return x + out, new_cache, aux


def _write_back(pooled: torch.Tensor, new: torch.Tensor) -> None:
    if new is not pooled:  # attention leaves were written in place already
        pooled.copy_(new)


def _apply_blocks(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, cache: Optional[Params] = None,
                  cache_pos: Optional[Offset] = None
                  ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Every layer; returns (x, cache, aux), aux the sum of the layers' MoE
    aux losses (through the checkpointed blocks too, as the reference's
    scan carries it).  A given cache is updated in place, layer by layer
    through views of its stacked leaves."""
    kinds = layer_kinds(cfg)
    P_ = period(cfg)

    def block_fn(xc: torch.Tensor, bp: Params, bc: Optional[Params]):
        new_bc = None if bc is None else {}
        aux_b = None
        for j in range(P_):
            xc, nc, a = _apply_sublayer(bp[f"sub{j}"], xc, cfg, kinds[j], positions=positions,
                                        cache=None if bc is None else bc[f"sub{j}"],
                                        cache_pos=cache_pos)
            if bc is not None:
                new_bc[f"sub{j}"] = nc
            if a is not None:
                aux_b = a if aux_b is None else aux_b + a
        return xc, new_bc, aux_b

    stacked = _stacked(cfg)
    blocks = unbind(params["blocks"]) if stacked else [params["blocks"]]
    if cache is None:
        caches = [None] * len(blocks)
    else:
        caches = unbind(cache) if stacked else [cache]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp, bc in zip(blocks, caches):
        if cfg.remat and torch.is_grad_enabled():
            x, new_bc, aux_b = checkpoint(block_fn, x, bp, bc, use_reentrant=False)
        else:
            x, new_bc, aux_b = block_fn(x, bp, bc)
        if aux_b is not None:
            aux = aux + aux_b
        if bc is not None:
            tree_map(_write_back, bc, new_bc)
    return x, cache, aux


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings; a VLM batch's ``patch_embeds`` (B, P, frontend_dim),
    projected by ``patch_proj``, replace the first ``num_patch_tokens``."""
    x = apply_embedding(params["embed"], batch["tokens"], cfg)
    if cfg.num_patch_tokens and "patch_embeds" in batch:
        patches = torch.einsum("bpe,ed->bpd", batch["patch_embeds"].to(x.dtype),
                               params["patch_proj"]["w"].to(x.dtype))
        x = torch.cat([patches, x[:, cfg.num_patch_tokens:]], dim=1)
    return x


def forward_train(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss, aux_loss); a VLM's patch positions are masked out of
    the loss, as the reference's."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = _apply_blocks(params, x, cfg, positions=positions)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = apply_lm_head(params.get("lm_head"), x, cfg, embed=params["embed"])
    targets = batch["targets"]
    if not cfg.num_patch_tokens:
        return cross_entropy_loss(logits, targets), aux
    B, T = targets.shape
    mask = torch.arange(T, device=x.device) >= cfg.num_patch_tokens
    lf = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return -(gold * mask[None]).sum() / max(max(T - cfg.num_patch_tokens, 0) * B, 1), aux


PREFILL_CHUNK = 8_192  # sequence-chunked prefill above this length


def _last_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return apply_lm_head(params.get("lm_head"), x, cfg, embed=params["embed"])[:, 0]


@torch.inference_mode()
def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Writes positions [0, S) into the cache; returns (last-position
    logits, cache).

    A decoder's prompt (dense, MLA or MoE) longer than ``PREFILL_CHUNK``
    (and a multiple of it) runs chunked, as the reference's (vLLM-style):
    each chunk of tokens attends over the cache written so far, so
    activation memory is O(chunk), not O(S); an MoE layer routes each chunk
    in its own groups, as there.  RWKV and the hybrid keep the single pass
    (their state is O(1) a token; the Mamba scan is chunked inside the
    layer instead), and so does a VLM (its patch prefix spans the
    chunks)."""
    tokens = batch["tokens"]
    S, C = tokens.shape[1], PREFILL_CHUNK
    if not (cfg.family == "decoder" and not cfg.hybrid_attn_period
            and not cfg.num_patch_tokens and S > C and S % C == 0):
        x = _embed_inputs(params, batch, cfg)
        x, cache, _ = _apply_blocks(params, x, cfg, positions=torch.arange(S, device=x.device),
                                    cache=cache, cache_pos=0)
        return _last_logits(params, x, cfg), cache
    for s0 in range(0, S, C):
        x = apply_embedding(params["embed"], tokens[:, s0:s0 + C], cfg)
        positions = torch.arange(s0, s0 + C, device=x.device)
        x, cache, _ = _apply_blocks(params, x, cfg, positions=positions, cache=cache,
                                    cache_pos=s0)
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
    else:
        host = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos)
        limit = _cache_len(cache)
        if host.min() < 0 or (limit is not None and host.max() >= limit):
            raise ValueError(f"decode positions {host.tolist()} outside a cache of {limit}")
        cache_pos = torch.tensor(host, dtype=torch.long, device=dev)
        positions = cache_pos[:, None]  # (B, 1)
    x = apply_embedding(params["embed"], tokens, cfg)
    x, cache, _ = _apply_blocks(params, x, cfg, positions=positions, cache=cache,
                                cache_pos=cache_pos)
    return _last_logits(params, x, cfg), cache
