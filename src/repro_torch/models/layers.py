"""Building blocks of the models: norms, RoPE, sinusoidal positions, MHA/GQA
and MLA attention, MLPs, embedding, LM head and the loss.

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
(prefill and decode, with per-slot positions) and its ``kv_source``
(cross-attention) branch, which no model calls: the encoder-decoder's
cross-attention is ``encdec._cross_attn`` over precomputed K/V, as in the
reference.  ``sinusoidal_embedding`` is the encoder-decoder's position
table.  ``apply_mla_attention`` (multi-head latent
attention) caches the latent and the shared rope key; with a cache and at
most ``MLA_ABSORB_MAX_S`` query positions it attends in the latent space
(the absorbed branch), otherwise it expands the latent over the whole
cache and calls ``_sdpa`` on the plain route, as the reference does (its
qk and v head dims differ, and it never takes the flash kernel).
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


def sinusoidal_embedding_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """The sinusoidal row of each position in ``pos``, shape ``pos.shape +
    (dim,)``, fp32: sin at the even columns, cos at the odd ones, of
    position * 10000^(-2i/dim)."""
    half = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device)
    ang = pos.to(torch.float32)[..., None] * torch.exp(half * (-math.log(10000.0) / dim))
    emb = torch.zeros((*pos.shape, dim), dtype=torch.float32, device=pos.device)
    emb[..., 0::2] = torch.sin(ang)
    emb[..., 1::2] = torch.cos(ang)
    return emb


def sinusoidal_embedding(length: int, dim: int,
                         device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """(length, dim) fp32: the rows of positions [0, length)."""
    return sinusoidal_embedding_at(torch.arange(length, device=device), dim)


# ---------------------------------------------------------------------------
# Attention (MHA / GQA)
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> Params:
    a = cfg.attention
    if a is None or a.kind not in ("mha", "gqa", "mla"):
        raise ValueError(f"the port's attention is mha, gqa or mla; got {a and a.kind!r}")
    d, dt, hd = cfg.d_model, pdtype(cfg), a.head_dim
    if a.kind == "mla":
        rd, nd, vd = a.qk_rope_head_dim, a.qk_nope_head_dim, a.v_head_dim
        dev = generator.device
        return {
            "wq_a": dense_init(generator, d, (a.q_lora_rank,), dt),
            "q_norm": torch.ones((a.q_lora_rank,), dtype=dt, device=dev),
            "wq_b": dense_init(generator, a.q_lora_rank, (a.num_heads, nd + rd), dt),
            "wkv_a": dense_init(generator, d, (a.kv_lora_rank,), dt),
            "kv_norm": torch.ones((a.kv_lora_rank,), dtype=dt, device=dev),
            "wk_rope": dense_init(generator, d, (rd,), dt),
            "wkv_b": dense_init(generator, a.kv_lora_rank, (a.num_heads, nd + vd), dt),
            "wo": dense_init(generator, a.num_heads * vd, (d,), dt).reshape(a.num_heads, vd, d),
        }
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


def _write_at(leaves: Tuple[torch.Tensor, ...], news: Tuple[torch.Tensor, ...],
              cache_pos: Offset) -> Tuple[torch.Tensor, ...]:
    """Write each of ``news`` (B,S,...) into its cache leaf (B,max_len,...)
    at ``cache_pos``, in place, and return the leaves.  An int writes one
    slice of every row (a write past ``max_len`` raises, where the
    reference's ``dynamic_update_slice`` clamps it onto earlier positions);
    a (B,) tensor writes row b at its own position (per-slot decode; the
    caller checks its bounds on the host, as ``transformer.decode_step``
    does)."""
    first = leaves[0]
    B, S, max_len = news[0].shape[0], news[0].shape[1], first.shape[1]
    if isinstance(cache_pos, torch.Tensor):
        rows = torch.arange(B, device=first.device)[:, None]
        cols = cache_pos.to(first.device).long()[:, None] + torch.arange(S, device=first.device)
        for leaf, new in zip(leaves, news):
            leaf[rows, cols] = new.to(leaf.dtype)
        return leaves
    if not 0 <= cache_pos <= max_len - S:
        raise ValueError(f"cache write of {S} positions at {cache_pos} runs past "
                         f"max_len {max_len}")
    for leaf, new in zip(leaves, news):
        leaf[:, cache_pos: cache_pos + S] = new.to(leaf.dtype)
    return leaves


def _cache_update(cache: Params, k: torch.Tensor, v: torch.Tensor,
                  cache_pos: Offset) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k, v (B,S,Hkv,D) into the cache's (B,max_len,Hkv,D) leaves at
    ``cache_pos`` (:func:`_write_at`) and return the leaves."""
    return _write_at((cache["k"], cache["v"]), (k, v), cache_pos)


def apply_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                    q_offset: int = 0, causal: bool = True, cache: Optional[Params] = None,
                    cache_pos: Optional[Offset] = None,
                    kv_source: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA/MHA attention; returns (y, cache).  Without a cache it runs over
    the whole sequence, and ``q_offset`` is ``positions[0]`` as a host int
    (the reference reads it from the array; here that would wait for the
    device).  With one, k and v are written at ``cache_pos`` (an int, or a
    (B,) tensor per slot) and q attends over the cache up to ``cache_pos +
    S``; q's positions start at ``cache_pos`` in every caller (prefill, its
    chunks, decode), so that is its offset.

    ``kv_source`` (B, T, d), cross-attention as the reference's
    (``layers.py:233-271``): k and v come from it, with no RoPE on the
    pair; with a cache, k and v are the cache's precomputed ``k`` and
    ``v``, nothing is written, no length is masked and ``q_offset`` stays
    the caller's."""
    a = cfg.attention
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    kv_len = None
    if kv_source is not None and cache is not None:
        k, v = cache["k"], cache["v"]
    else:
        src = x if kv_source is None else kv_source
        k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(x.dtype))
        if a.rope and kv_source is None:
            q = apply_rope(q, positions, a.rope_theta)
            k = apply_rope(k, positions, a.rope_theta)
        if cache is not None:
            k, v = _cache_update(cache, k, v, cache_pos)
            cache = {"k": k, "v": v}
            q_offset, kv_len = cache_pos, cache_pos + S
    qg = q.reshape(B, S, a.num_kv_heads, a.q_heads_per_kv, a.head_dim)
    out = _sdpa(qg, k.to(x.dtype), v.to(x.dtype), causal=causal, q_offset=q_offset,
                kv_len=kv_len, impl=cfg.attention_impl)
    out = out.reshape(B, S, a.num_heads, a.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), cache


MLA_ABSORB_MAX_S = 64  # with a cache, q lengths up to this attend in the latent space (0: never)


def _mla_rms(z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """MLA's inner RMSNorm: fp32, eps 1e-6, an fp32 scale."""
    zf = z.float()
    return (zf * torch.rsqrt((zf * zf).mean(-1, keepdim=True) + 1e-6)
            * scale.float()).to(z.dtype)


def apply_mla_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                        positions: torch.Tensor, q_offset: int = 0, causal: bool = True,
                        cache: Optional[Params] = None, cache_pos: Optional[Offset] = None
                        ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Multi-head latent attention (MiniCPM3 / DeepSeek-V2), as
    ``repro/models/layers.py:279-379``; returns (y, cache).

    The cache holds only the normalized latent ``c_kv`` (kv_lora_rank) and
    the shared rope key ``k_rope`` (qk_rope_head_dim), written in place at
    ``cache_pos`` as :func:`_write_at` writes.  With a cache and S <=
    ``MLA_ABSORB_MAX_S``, wkv_b's key half is absorbed into the query and
    its value half into the output, so the cache is never expanded;
    otherwise (training, long prefill, each prefill chunk) the latent is
    expanded to per-head keys and values over the whole cache length and
    attended by ``_sdpa`` on its plain route, masked at ``kv_len``.
    ``q_offset`` is as in :func:`apply_attention`."""
    a = cfg.attention
    B, S, _ = x.shape
    rd, nd, vd, H = a.qk_rope_head_dim, a.qk_nope_head_dim, a.v_head_dim, a.num_heads

    cq = _mla_rms(x @ p["wq_a"].to(x.dtype), p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"].to(x.dtype))  # (B,S,H,nd+rd)
    q_nope, q_rope = q[..., :nd], apply_rope(q[..., nd:], positions, a.rope_theta)
    c_kv = _mla_rms(x @ p["wkv_a"].to(x.dtype), p["kv_norm"])  # (B,S,r)
    k_rope = apply_rope((x @ p["wk_rope"].to(x.dtype))[:, :, None], positions,
                        a.rope_theta)[:, :, 0]  # (B,S,rd)

    kv_len = None
    if cache is not None:
        c_kv, k_rope = _write_at((cache["c_kv"], cache["k_rope"]), (c_kv, k_rope), cache_pos)
        cache = {"c_kv": c_kv, "k_rope": k_rope}
        q_offset, kv_len = cache_pos, cache_pos + S

    if cache is not None and S <= MLA_ABSORB_MAX_S:
        wkv_b = p["wkv_b"].to(x.dtype)  # (r, H, nd+vd)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wkv_b[..., :nd])  # (B,S,H,r)
        ckv, krt = c_kv.to(x.dtype), k_rope.to(x.dtype)  # (B,T,r), (B,T,rd)
        scores = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
                  + torch.einsum("bshr,btr->bhst", q_rope, krt)).float() * (1.0 / math.sqrt(nd + rd))
        T = ckv.shape[1]
        tpos = torch.arange(T, device=x.device)
        qpos = torch.arange(S, device=x.device)[None, :] + _per_row(q_offset)  # (B|1,S)
        mask = (tpos[None, None, :] <= qpos[:, :, None]) \
            & (tpos[None, :] < _per_row(kv_len))[:, None, :]
        w = torch.softmax(scores.masked_fill(~mask[:, None], NEG_INF), dim=-1).to(x.dtype)
        out_lat = torch.einsum("bhst,btr->bshr", w, ckv)  # (B,S,H,r)
        out = torch.einsum("bshr,rhv->bshv", out_lat, wkv_b[..., nd:])  # (B,S,H,vd)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), cache

    kv = torch.einsum("btr,rhk->bthk", c_kv.to(x.dtype), p["wkv_b"].to(x.dtype))
    k_nope, v = kv[..., :nd], kv[..., nd:]
    T = k_nope.shape[1]
    k = torch.cat([k_nope, k_rope[:, :, None, :].to(x.dtype).expand(B, T, H, rd)], dim=-1)
    qh = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, H, 1, nd + rd)
    out = _sdpa(qh, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    out = out.reshape(B, S, H, vd)
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
