"""Building blocks of the dense decoder: norms, RoPE, MHA/GQA attention,
MLPs, embedding, LM head and the loss.

Plain functions over parameter trees (nested dicts of tensors) laid out as
the JAX reference's (``repro/models/layers.py``), so both packages start from
the same weights (:func:`repro_torch.convert.lm_params_from_jax`).  As there,
parameters are fp32 and the compute dtype is ``cfg.dtype`` (bf16): every
einsum runs in the compute dtype, norms and the softmax in fp32, masked
scores are ``-1e30``.

Attention dispatch (``_sdpa``) follows ``layers.py:167-191``:
``attention_impl="pallas"`` takes the hand-written flash kernel
(:mod:`repro_torch.kernels.flash_attention`) for causal self-attention with
no cache and ``S == T``; otherwise q lengths of 4096 and more (multiples of
1024) take the q-chunked ``_sdpa_chunked``, and shorter ones ``_sdpa_dense``.
``apply_attention`` has the reference's self-attention KV-cache branch
(prefill and decode, with per-slot positions); cross-attention and MLA come
with their slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

Params = Dict[str, Any]
NEG_INF = -1e30
CHUNKED_SDPA_THRESHOLD = 4_096  # q length from which the q-chunked path is taken

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def dense_init(generator: torch.Generator, in_dim: int, out_shape: Tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/in_dim) of shape (in_dim, *out_shape), drawn on the generator's
    device."""
    w = torch.randn((in_dim, *out_shape), generator=generator, device=generator.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device: Union[str, torch.device]) -> Params:
    d = cfg.d_model
    p = {"scale": torch.ones((d,), dtype=pdtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=pdtype(cfg), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotate pairs (first half with second half);
    positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (MHA / GQA)
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> Params:
    a = cfg.attention
    if a is None or a.kind not in ("mha", "gqa"):
        raise ValueError(f"the port's attention is mha or gqa; got {a and a.kind!r}")
    d, dt, hd = cfg.d_model, pdtype(cfg), a.head_dim
    return {
        "wq": dense_init(generator, d, (a.num_heads, hd), dt),
        "wk": dense_init(generator, d, (a.num_kv_heads, hd), dt),
        "wv": dense_init(generator, d, (a.num_kv_heads, hd), dt),
        "wo": dense_init(generator, a.num_heads * hd, (d,), dt).reshape(a.num_heads, hd, d),
    }


Offset = Union[int, torch.Tensor]  # a host int, or a (B,) tensor on q's device


def _per_row(offset: Offset) -> Offset:
    """An int stays an int (a kernel argument: nothing crosses to the
    device); a (B,) tensor becomes (B, 1)."""
    return offset[:, None] if isinstance(offset, torch.Tensor) else offset


def _sdpa_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                q_offset: Offset, kv_len: Optional[Offset] = None) -> torch.Tensor:
    """q: (B,S,Hkv,G,D), k, v: (B,T,Hkv,D).  Matmuls in the compute dtype,
    softmax in fp32.  ``q_offset`` is the position of q[0], ``kv_len`` the
    valid cache length (positions from it on are masked): each an int, or a
    (B,) tensor for per-slot decode, so the mask is (B|1, S, T) as the
    reference's."""
    B, S, Hkv, G, D = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    scores = (torch.einsum("bshgd,bthd->bhgst", q, k) * scale).float()  # (B,Hkv,G,S,T)
    tpos = torch.arange(T, device=q.device)
    mask = None
    if causal:
        qpos = torch.arange(S, device=q.device)[None, :] + _per_row(q_offset)  # (B|1,S)
        mask = tpos[None, None, :] <= qpos[:, :, None]
    if kv_len is not None:
        valid = (tpos[None, :] < _per_row(kv_len))[:, None, :]  # (B|1,1,T)
        mask = valid if mask is None else mask & valid
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgst,bthd->bshgd", w, v)  # (B,S,Hkv,G,Dv)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  q_offset: Offset, kv_len: Optional[Offset] = None,
                  chunk: int = 1024) -> torch.Tensor:
    """O(S) score memory: ``_sdpa_dense`` over q chunks, so one (chunk x T)
    score tile is live at a time (the reference's ``lax.scan``)."""
    S = q.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"q length {S} is not a multiple of the chunk {chunk}")
    outs = [
        _sdpa_dense(q[:, i: i + chunk], k, v, causal=causal, q_offset=q_offset + i,
                    kv_len=kv_len)
        for i in range(0, S, chunk)
    ]
    return torch.cat(outs, dim=1)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          q_offset: Offset, kv_len: Optional[Offset] = None, impl: str = "ref") -> torch.Tensor:
    """Dispatch as ``layers.py:167-191``: the flash kernel only for causal
    self-attention with no cache (``kv_len is None``) and ``S == T``, so
    prefill and decode, which attend over a cache, never take it."""
    S = q.shape[1]
    if impl == "pallas" and kv_len is None and causal and S == k.shape[1]:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        B, _, Hkv, G, D = q.shape
        qf = q.reshape(B, S, Hkv * G, D).transpose(1, 2)  # (B,Hq,S,D), a view
        out = flash_attention(qf, k.transpose(1, 2), v.transpose(1, 2), causal=True)
        return out.transpose(1, 2).reshape(B, S, Hkv, G, D)
    if S >= CHUNKED_SDPA_THRESHOLD and S % 1024 == 0:
        return _sdpa_chunked(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    return _sdpa_dense(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)


def _cache_update(cache: Params, k: torch.Tensor, v: torch.Tensor,
                  cache_pos: Offset) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k, v (B,S,Hkv,D) into the cache's (B,max_len,Hkv,D) leaves at
    ``cache_pos``, in place, and return the leaves.  An int writes one slice
    of every row (a write past ``max_len`` raises, where the reference's
    ``dynamic_update_slice`` clamps it onto earlier positions); a (B,)
    tensor writes row b at its own position (per-slot decode; the caller
    checks its bounds on the host, as ``transformer.decode_step`` does)."""
    kc, vc = cache["k"], cache["v"]
    S, max_len = k.shape[1], kc.shape[1]
    if isinstance(cache_pos, torch.Tensor):
        rows = torch.arange(k.shape[0], device=kc.device)[:, None]
        cols = cache_pos.to(kc.device).long()[:, None] + torch.arange(S, device=kc.device)
        kc[rows, cols] = k.to(kc.dtype)
        vc[rows, cols] = v.to(vc.dtype)
        return kc, vc
    if not 0 <= cache_pos <= max_len - S:
        raise ValueError(f"cache write of {S} positions at {cache_pos} runs past "
                         f"max_len {max_len}")
    kc[:, cache_pos: cache_pos + S] = k.to(kc.dtype)
    vc[:, cache_pos: cache_pos + S] = v.to(vc.dtype)
    return kc, vc


def apply_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                    q_offset: int = 0, causal: bool = True, cache: Optional[Params] = None,
                    cache_pos: Optional[Offset] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA/MHA self-attention; returns (y, cache).  Without a cache it runs
    over the whole sequence, and ``q_offset`` is ``positions[0]`` as a host
    int (the reference reads it from the array; here that would wait for
    the device).  With one, k and v are written at ``cache_pos`` (an int,
    or a (B,) tensor per slot) and q attends over the cache up to
    ``cache_pos + S``; q's positions start at ``cache_pos`` in every caller
    (prefill, its chunks, decode), so that is its offset.  Cross-attention
    (the reference's ``kv_source``) comes with the encoder-decoder family."""
    a = cfg.attention
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if a.rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    kv_len = None
    if cache is not None:
        k, v = _cache_update(cache, k, v, cache_pos)
        cache = {"k": k, "v": v}
        q_offset, kv_len = cache_pos, cache_pos + S
    qg = q.reshape(B, S, a.num_kv_heads, a.q_heads_per_kv, a.head_dim)
    out = _sdpa(qg, k.to(x.dtype), v.to(x.dtype), causal=causal, q_offset=q_offset,
                kv_len=kv_len, impl=cfg.attention_impl)
    out = out.reshape(B, S, a.num_heads, a.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, pdtype(cfg)
    if cfg.mlp == "swiglu":
        return {
            "w_gate": dense_init(generator, d, (f,), dt),
            "w_up": dense_init(generator, d, (f,), dt),
            "w_down": dense_init(generator, f, (d,), dt),
        }
    return {  # relu2 | gelu
        "w_up": dense_init(generator, d, (f,), dt),
        "w_down": dense_init(generator, f, (d,), dt),
    }


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        g = x @ p["w_gate"].to(x.dtype)
        u = x @ p["w_up"].to(x.dtype)
        h = F.silu(g) * u
    else:
        h = x @ p["w_up"].to(x.dtype)
        if cfg.mlp == "relu2":  # nemotron squared-ReLU
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------


def init_embedding(generator: torch.Generator, cfg: ModelConfig) -> Params:
    w = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator, device=generator.device)
    return {"w": (w * 0.02).to(pdtype(cfg))}


def apply_embedding(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), p["w"].to(cdtype(cfg)))


def init_lm_head(generator: torch.Generator, cfg: ModelConfig) -> Params:
    return {"w": dense_init(generator, cfg.d_model, (cfg.vocab_size,), pdtype(cfg))}


def apply_lm_head(p: Optional[Params], x: torch.Tensor, cfg: ModelConfig,
                  embed: Optional[Params] = None) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = embed["w"].to(x.dtype).t()
    else:
        w = p["w"].to(x.dtype)
    return x @ w


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    loss = logz - gold
    if label_smoothing:
        mean_all = logz - logits.mean(-1)
        loss = (1 - label_smoothing) * loss + label_smoothing * mean_all
    return loss.mean()
