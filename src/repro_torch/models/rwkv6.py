"""RWKV-6 "Finch": linear attention with data-dependent decay (the
reference's ``repro/models/rwkv6.py``).

Per head (dim D) with matrix state S (D x D):
    y_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
where the decay w_t = exp(-exp(w0 + lora_w(x_t))) is *data dependent* (the
Finch contribution).  Token shift mixes x_t with x_{t-1} per stream.

Scan strategies, as in the reference:
* ``seq``   — a loop over time (exact; the decode path).
* ``chunk`` — the chunked matrix form (intra-chunk matmuls + inter-chunk
  state), fp32 within chunks for the decay ratios; the reference's
  ``lax.scan`` over chunks is a Python loop.  It divides k by a product of
  up to 32 decays, which underflows fp32 when a chunk's mean decay is below
  about 0.065; the reference has the same hazard and this twin keeps it.
* ``wkv_impl`` — a function of (r, k, v, w, u, s0), such as
  :func:`repro_torch.kernels.rwkv6_wkv.ops.wkv` (the hand-written kernel).

Channel-mix is the RWKV squared-ReLU FFN.  Parameters are fp32, the
projections run in the compute dtype (bf16), the recurrence, the decay and
the per-head groupnorm in fp32.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import Params, dense_init, pdtype

CHUNK = 32


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    r = cfg.rwkv
    if r is None:
        raise ValueError(f"{cfg.name} has no rwkv config")
    return cfg.d_model // r.head_dim, r.head_dim


def init_rwkv_timemix(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, dt, dev = cfg.d_model, pdtype(cfg), generator.device
    H, D = _dims(cfg)
    full = lambda shape, value: torch.full(shape, value, dtype=dt, device=dev)  # noqa: E731
    u = torch.randn((H, D), generator=generator, device=dev) * 0.1
    return {
        "mu_r": full((d,), 0.5),
        "mu_k": full((d,), 0.5),
        "mu_v": full((d,), 0.5),
        "mu_w": full((d,), 0.5),
        "mu_g": full((d,), 0.5),
        "w_r": dense_init(generator, d, (H, D), dt),
        "w_k": dense_init(generator, d, (H, D), dt),
        "w_v": dense_init(generator, d, (H, D), dt),
        "w_g": dense_init(generator, d, (H, D), dt),
        "w_o": dense_init(generator, d, (d,), dt),
        # data-dependent decay: w0 + B_w @ tanh(A_w @ x_w)
        "w0": full((H, D), -0.6),
        "lora_a": dense_init(generator, d, (cfg.rwkv.decay_lora,), dt),
        "lora_b": dense_init(generator, cfg.rwkv.decay_lora, (H, D), dt) * 0.1,
        "u": u.to(dt),
        "ln_scale": full((H, D), 1.0),
        "ln_bias": full((H, D), 0.0),
    }


def init_rwkv_channelmix(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, dt, dev = cfg.d_model, pdtype(cfg), generator.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=dt, device=dev),
        "w_k": dense_init(generator, d, (cfg.d_ff,), dt),
        "w_v": dense_init(generator, cfg.d_ff, (d,), dt),
        "w_r": dense_init(generator, d, (d,), dt),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} stream: zeros (or the cache) at t=0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv_scan_seq(r, k, v, w, u, s0):
    """Reference recurrence.  r,k,v,w: (B,S,H,D) fp32; u: (H,D); s0: (B,H,D,D).
    Returns y (B,S,H,D), sT."""
    s, ys = s0, []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # (B,H,D)
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        bonus = torch.einsum("bhk,bhk->bh", r_t, u[None] * k_t)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, s) + bonus[..., None] * v_t)
        s = w_t[..., None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_scan_chunked(r, k, v, w, u, s0, chunk: int = CHUNK):
    """Chunked matrix formulation (see the module docstring).  Shapes as
    :func:`wkv_scan_seq`."""
    B, S, H, D = r.shape
    pad = (-S) % chunk
    if pad:
        zeros = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))  # noqa: E731
        r, k, v = zeros(r), zeros(k), zeros(v)
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)  # padded steps keep the state
    nC = (S + pad) // chunk
    # one unbind per input (views), as the reference's reshape: its backward
    # stacks the chunks' gradients in one pass, where slicing a[:, c0:c0+c]
    # per chunk would make each chunk's backward fill and add a zero tensor
    # the size of the whole sequence
    chunks = [a.reshape(B, nC, chunk, H, D).unbind(1) for a in (r, k, v, w)]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    s, ys = s0, []
    for rc_, kc_, vc_, wc_ in zip(*chunks):  # (B,c,H,D)
        logw = torch.log(torch.clamp(wc_, min=1e-12))
        Pincl = torch.exp(torch.cumsum(logw, dim=1))        # prod_{s<=t} w_s
        Pexcl = Pincl / wc_                                  # prod_{s<t} w_s
        Ptot = Pincl[:, -1]                                  # (B,H,D)
        r_t = rc_ * Pexcl                                    # r~
        k_s = kc_ / Pincl                                    # k~
        # intra-chunk: strictly-lower-triangular attention + diagonal bonus
        att = torch.einsum("bthd,bshd->bhts", r_t, k_s)      # (B,H,c,c)
        att = torch.where(tri[None, None], att, 0.0)
        diag = torch.einsum("bthd,bthd->bth", rc_, u[None, None] * kc_)
        y = torch.einsum("bhts,bshd->bthd", att, vc_)
        y = y + diag[..., None] * vc_
        # inter-chunk: contribution of the carried state
        y = y + torch.einsum("bthk,bhkv->bthv", r_t, s)
        # state update: S' = diag(Ptot) S + sum_s diag(Ptot/P_s) k_s v_s^T
        kw = kc_ * (Ptot[:, None] / Pincl)
        s = Ptot[..., None] * s + torch.einsum("bshk,bshv->bhkv", kw, vc_)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], s


def apply_rwkv_timemix(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[Params] = None,
    scan_mode: str = "chunk",
    wkv_impl: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    B, S, d = x.shape
    H, D = _dims(cfg)
    prev = cache["shift_tm"] if cache is not None else None
    xp = _token_shift(x, prev)

    def mix(mu):
        return x + (xp - x) * mu.to(x.dtype)

    xr, xk, xv, xw, xg = (mix(p[f"mu_{c}"]) for c in "rkvwg")
    proj = lambda z, w_: torch.einsum("bsd,dhk->bshk", z, w_.to(x.dtype))  # noqa: E731
    r = proj(xr, p["w_r"]).float()
    k = proj(xk, p["w_k"]).float()
    v = proj(xv, p["w_v"]).float()
    g = F.silu(proj(xg, p["w_g"]))
    # data-dependent decay (Finch), in fp32
    lora = torch.einsum(
        "bsr,rhk->bshk",
        torch.tanh(torch.einsum("bsd,dr->bsr", xw, p["lora_a"].to(x.dtype))),
        p["lora_b"].to(x.dtype),
    )
    w = torch.exp(-torch.exp(p["w0"].float()[None, None] + lora.float()))

    if cache is not None:
        s0 = cache["state"]
    else:
        s0 = torch.zeros((B, H, D, D), dtype=torch.float32, device=x.device)
    u = p["u"].float()
    if wkv_impl is not None:
        y, sT = wkv_impl(r, k, v, w, u, s0)
    elif scan_mode == "chunk" and S > 1:
        y, sT = wkv_scan_chunked(r, k, v, w, u, s0)
    else:
        y, sT = wkv_scan_seq(r, k, v, w, u, s0)
    # per-head groupnorm (population variance, as jnp.var)
    mu_ = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu_) * torch.rsqrt(var + 1e-5)
    y = y * p["ln_scale"].float()[None, None] + p["ln_bias"].float()[None, None]
    y = (y.to(x.dtype) * g).reshape(B, S, d)
    out = torch.einsum("bsd,de->bse", y, p["w_o"].to(x.dtype))
    new_cache = None
    if cache is not None:
        new_cache = {"state": sT, "shift_tm": x[:, -1].float()}
    return out, new_cache


def apply_rwkv_channelmix(
    p: Params, x: torch.Tensor, cfg: ModelConfig, *, cache: Optional[Params] = None
) -> Tuple[torch.Tensor, Optional[Params]]:
    prev = cache["shift_cm"] if cache is not None else None
    xp = _token_shift(x, prev)
    xk = x + (xp - x) * p["mu_k"].to(x.dtype)
    xr = x + (xp - x) * p["mu_r"].to(x.dtype)
    k = torch.einsum("bsd,df->bsf", xk, p["w_k"].to(x.dtype))
    v = torch.einsum("bsf,fd->bsd", torch.square(F.relu(k)), p["w_v"].to(x.dtype))
    rgate = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["w_r"].to(x.dtype)))
    new_cache = {"shift_cm": x[:, -1].float()} if cache is not None else None
    return rgate * v, new_cache


def init_rwkv_cache(cfg: ModelConfig, batch: int,
                    device: Union[str, torch.device] = "cuda") -> Params:
    H, D = _dims(cfg)
    device = resolve_device(device)
    return {
        "state": torch.zeros((batch, H, D, D), dtype=torch.float32, device=device),
        "shift_tm": torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
        "shift_cm": torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
    }
