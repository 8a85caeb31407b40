"""Mamba-1 selective SSM block, the jamba mixer (the reference's
``repro/models/ssm.py``).

Recurrence (per channel i, state n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

Two scan strategies, as in the reference:

* ``assoc`` — a log-depth (Hillis–Steele) scan over time, where the
  reference takes ``jax.lax.associative_scan``: the same recurrence, its
  fp32 products and sums in another order.
* ``seq`` — a loop over time (the decode path: one token with a cache).

The reference forms dA, dBx and the states for the whole sequence, each
(B, S, d_inner, d_state) fp32: 512 KiB a token at jamba's width (d_inner
8192 × d_state 16), 8.6 GB each for one 16384-token prompt.
:func:`apply_mamba` runs the same scan ``SCAN_CHUNK`` tokens at a time
instead (:func:`_scan_chunked`): it carries h (B, d_inner, d_state) from
chunk to chunk, forms a chunk's dA and dBx from dt, A, B and x, and
contracts the chunk's states with C before the next chunk.  No tensor spans
the whole sequence × d_inner × d_state.  A chunk's working set at jamba's
width is about 7 tensors of (B, 128, 8192, 16) fp32 (dA and dBx, the scan's
pair and its level's products), 64 MiB each a batch row: about 0.45 GiB at
B = 1.  The scan reads and writes each chunk's pair once a level, log2 of
the chunk's length levels, so a shorter chunk moves fewer bytes and
launches more kernels: at full width the card's memory sets the pace and
a shorter chunk is faster (``chip_smoke.py``'s ``c_scan_chunk`` times one
full-width layer at several chunks), while a narrow model, all launches,
runs faster with longer ones.

The projections run in the compute dtype (bf16), the depthwise conv as the
reference's sum of ``d_conv`` shifted products in that dtype, then
``+ conv_b`` (``F.conv1d`` would accumulate in fp32); B, C, dt and the scan
in fp32.  dt's softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``
(``F.softplus`` returns x itself above its threshold).  Decode carries
(conv, ssm) in the cache, both fp32, which the transformer writes into the
pooled cache in place.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import Params, dense_init, pdtype

SCAN_CHUNK = 128  # tokens a chunk of apply_mamba's scan


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    if s is None:
        raise ValueError(f"{cfg.name} has no ssm config")
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, s.d_state, s.d_conv, dt_rank


def init_mamba(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """The reference's tree and shapes, drawn from ``generator`` on its
    device; ``A_log`` is log(1..d_state) on every channel, as there."""
    d = cfg.d_model
    d_inner, d_state, d_conv, dt_rank = _dims(cfg)
    dt, dev = pdtype(cfg), generator.device
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)[None].repeat(d_inner, 1)
    conv_w = torch.randn((d_conv, d_inner), generator=generator, device=dev) * 0.2
    return {
        "in_proj": dense_init(generator, d, (2 * d_inner,), dt),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((d_inner,), dtype=dt, device=dev),
        "x_proj": dense_init(generator, d_inner, (dt_rank + 2 * d_state,), dt),
        "dt_proj": dense_init(generator, dt_rank, (d_inner,), dt),
        "dt_bias": torch.zeros((d_inner,), dtype=dt, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones((d_inner,), dtype=dt, device=dev),
        "out_proj": dense_init(generator, d_inner, (d,), dt),
    }


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every h_t of h_t = a_t * h_{t-1} + b_t (h_0 = 0) along dim 1, in
    log2(S) levels: at offset k, element t takes in the composition ending
    at t - k."""
    S, k = a.shape[1], 1
    while k < S:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:], b[:, :-k])], dim=1)
        if 2 * k < S:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def _ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
              h0: Optional[torch.Tensor], mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """dA, dBx: (B, S, d_inner, d_state); C: (B, S, d_state).
    Returns y (B, S, d_inner) and final state (B, d_inner, d_state)."""
    if mode == "assoc":
        if h0 is not None:
            # fold initial state into the first step: h1 = dA1*h0 + dBx1
            dBx = torch.cat([torch.addcmul(dBx[:, :1], dA[:, :1], h0[:, None]), dBx[:, 1:]],
                            dim=1)
        hs = _assoc_scan(dA, dBx)
        y = torch.einsum("bsdn,bsn->bsd", hs, C)
        return y, hs[:, -1].clone()  # not a view: the chunk's states are freed
    if mode != "seq":
        raise ValueError(f"scan mode {mode!r}: 'assoc' or 'seq'")
    h = torch.zeros_like(dA[:, 0]) if h0 is None else h0
    ys = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]  # (B, d_inner, d_state)
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, dim=1), h


def _scan_chunked(dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
                  xc: torch.Tensor, h0: Optional[torch.Tensor], mode: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dA = exp(dt A), dBx = dt B x and ``_ssm_scan`` over
    the whole sequence, ``SCAN_CHUNK`` tokens at a time with h carried
    between chunks.  dt, xc: (B, S, d_inner) fp32; A: (d_inner, d_state); Bmat,
    Cmat: (B, S, d_state) fp32.  Returns y (B, S, d_inner), final state."""
    ys, h = [], h0
    # split, not slices: its backward concatenates the chunks' gradients once
    for dt_c, B_c, C_c, x_c in zip(*(t.split(SCAN_CHUNK, dim=1) for t in (dt, Bmat, Cmat, xc))):
        dA = torch.exp(dt_c[..., None] * A)  # (B, c, d_inner, d_state)
        dBx = dt_c[..., None] * B_c[:, :, None, :] * x_c[..., None]
        y, h = _ssm_scan(dA, dBx, C_c, h, mode)
        del dA, dBx
        ys.append(y)
    return torch.cat(ys, dim=1), h


def apply_mamba(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Params] = None, scan_mode: str = "assoc"
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, d). cache = {"conv": (B, d_conv-1, d_inner), "ssm": (B,
    d_inner, d_state)}; returns (out (B, S, d), the new cache or None)."""
    B, S, _ = x.shape
    d_inner, d_state, d_conv, dt_rank = _dims(cfg)
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    xi, z = xz[..., :d_inner], xz[..., d_inner:]

    # causal depthwise conv over time
    if cache is not None:
        ctx = torch.cat([cache["conv"].to(xi.dtype), xi], dim=1)
    else:
        ctx = F.pad(xi, (0, 0, d_conv - 1, 0))
    new_conv = ctx[:, -(d_conv - 1):]
    w = p["conv_w"].to(xi.dtype)  # (d_conv, d_inner)
    xc = sum(ctx[:, i:i + S] * w[i] for i in range(d_conv)) + p["conv_b"].to(xi.dtype)
    xc = F.silu(xc)

    proj = torch.einsum("bsd,de->bse", xc, p["x_proj"].to(xc.dtype))
    dt_in = proj[..., :dt_rank]
    Bmat = proj[..., dt_rank:dt_rank + d_state].float()
    Cmat = proj[..., dt_rank + d_state:].float()
    u = torch.einsum("bsr,rd->bsd", dt_in, p["dt_proj"].to(dt_in.dtype)).float() \
        + p["dt_bias"].float()
    dt = torch.logaddexp(u, torch.zeros((), device=u.device))  # softplus, (B, S, d_inner)
    A = -torch.exp(p["A_log"].float())  # (d_inner, d_state)

    h0 = cache["ssm"] if cache is not None else None
    mode = "seq" if (cache is not None and S == 1) else scan_mode
    y, hT = _scan_chunked(dt, A, Bmat, Cmat, xc.float(), h0, mode)
    y = y.to(x.dtype) + xc * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    new_cache = {"conv": new_conv.float(), "ssm": hT} if cache is not None else None
    return out, new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     device: Union[str, torch.device] = "cuda") -> Params:
    d_inner, d_state, d_conv, _ = _dims(cfg)
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=torch.float32, device=dev),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=dev),
    }
