"""A dense GQA decoder (granite-8b-code's layout), plainly, over ``{path: tensor}``.

Token embedding; per layer x += attn(rmsnorm(x)), x += mlp(rmsnorm(x));
a final RMSNorm (eps from the configuration, no bias, scale on the
normalized value) and an untied head; mean token cross-entropy.  RoPE
rotates the first half of each head against the second with frequencies
theta^(-2i/D).  Attention is causal, each group of query heads sharing a
key/value head, softmax(q k^T / sqrt(D)) v, taken over blocks of 1024
queries so the scores fit.  The MLP is SwiGLU, w_down(silu(x w_gate) *
(x w_up)).  Every layer is recomputed in the backward pass to bound memory.

Arithmetic: float32 throughout (TF32 off) is the reference.  With
``fp8=True`` every matmul's operands are first rounded to float8 e4m3, each
tensor scaled by its own absolute maximum (the control: the precision
below the configuration's bfloat16).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensors = Dict[str, torch.Tensor]
BLOCK = "blocks/sub0"
Q_BLOCK = 1024


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale; the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def _q(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    return _Fp8.apply(x) if fp8 else x


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D)."""
    d, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fp8: bool) -> torch.Tensor:
    """q: (B, S, Hkv, G, D); k, v: (B, S, Hkv, D); causal."""
    S, D = q.shape[1], q.shape[-1]
    kq, vq = _q(k, fp8), _q(v, fp8)
    outs = []
    for i in range(0, S, Q_BLOCK):
        qi = q[:, i:i + Q_BLOCK]
        n = qi.shape[1]
        scores = torch.einsum("bshgd,bthd->bhgst", _q(qi, fp8), kq[:, :i + n]) / D ** 0.5
        mask = torch.arange(i + n, device=q.device)[None, :] <= torch.arange(
            i, i + n, device=q.device)[:, None]
        w = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(torch.einsum("bhgst,bthd->bshgd", _q(w, fp8), vq[:, :i + n]))
    return torch.cat(outs, dim=1)


def _layer(x: torch.Tensor, lp: Tensors, cfg: Dict, fp8: bool) -> torch.Tensor:
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    B, S, _ = x.shape
    h_kv, hd = cfg["num_key_value_heads"], cfg["head_dim"]
    g = cfg["num_attention_heads"] // h_kv

    def mm(a: torch.Tensor, w: torch.Tensor, eq: str) -> torch.Tensor:
        return torch.einsum(eq, _q(a, fp8), _q(w, fp8))

    h = _rms(x, lp["ln1/scale"], eps)
    q = _rope(mm(h, lp["attn/wq"], "bsd,dhk->bshk"), theta)
    k = _rope(mm(h, lp["attn/wk"], "bsd,dhk->bshk"), theta)
    v = mm(h, lp["attn/wv"], "bsd,dhk->bshk")
    o = _attention(q.reshape(B, S, h_kv, g, hd), k, v, fp8).reshape(B, S, -1, hd)
    x = x + mm(o, lp["attn/wo"], "bshk,hkd->bsd")
    h = _rms(x, lp["ln2/scale"], eps)
    a = F.silu(mm(h, lp["mlp/w_gate"], "bsd,df->bsf")) * mm(h, lp["mlp/w_up"], "bsd,df->bsf")
    return x + mm(a, lp["mlp/w_down"], "bsf,fd->bsd")


def loss(cfg: Dict, P: Tensors, tokens: torch.Tensor, targets: torch.Tensor,
         fp8: bool = False) -> torch.Tensor:
    names = [n for n in P if n.startswith(BLOCK + "/")]
    per_layer = {n: P[n].unbind(0) for n in names}
    x = P["embed/w"][tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        lp = {n[len(BLOCK) + 1:]: per_layer[n][i] for n in names}
        x = checkpoint(_layer, x, lp, cfg, fp8, use_reentrant=False)
    x = _rms(x, P["final_norm/scale"], cfg["rms_norm_eps"])
    logits = torch.einsum("bsd,dv->bsv", _q(x, fp8), _q(P["lm_head/w"], fp8))
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean()


def grads(cfg: Dict, P: Tensors, tokens: torch.Tensor, targets: torch.Tensor,
          microbatches: int, fp8: bool = False) -> Tuple[float, Tensors]:
    """(mean loss, mean gradient) over the microbatches of one step."""
    names: List[str] = list(P)
    leaves = [P[n].detach().requires_grad_(True) for n in names]
    tree = dict(zip(names, leaves))
    n = tokens.shape[0] // microbatches
    total, acc = 0.0, None
    for m in range(microbatches):
        lo = loss(cfg, tree, tokens[m * n:(m + 1) * n], targets[m * n:(m + 1) * n], fp8)
        g = torch.autograd.grad(lo, leaves)
        total += lo.item()
        acc = list(g) if acc is None else [a.add_(b) for a, b in zip(acc, g)]
        del g
    return total / microbatches, {k: a.div_(microbatches) for k, a in zip(names, acc)}
