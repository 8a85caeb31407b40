"""Plain PyTorch versions of ``flash_attention`` and of its backward.

:func:`attention_ref` is the same function as the kernels in
``csrc/flash_attention.cu`` and ``csrc/flash_attention_sm90.cu`` (and the
reference's ``flash_attention`` wrapper): inputs upcast to fp32 (float64
stays float64), scale ``1/sqrt(D)``, causal mask with ``q_offset = T - S``
and masked scores at ``-1e30``, softmax and ``p @ v``, output cast back to
``q.dtype``; with ``with_lse`` it also returns each row's log-sum-exp of its
scaled, masked scores (fp32; float64 for float64), which the backward
recomputes P from.  GQA
reads kv head ``h // (Hq // Hkv)``.  O(S*T) memory: it is the oracle the
kernel is held to, not a path the model takes on a card.

:func:`attention_bwd_ref` is the plain version of
``csrc/flash_attention_bwd_sm90.cu``: dq, dk and dv from q, k, v, o, lse and
do by the flash algorithm, key block by key block, with P recomputed from
lse and ``Delta = rowsum(do * o)``; the reference has no backward of its
own (its kernel defines no VJP).
"""
import math
from typing import Optional

import torch

NEG_INF = -1e30


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: fp32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def attention_ref(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    causal: bool = True,
    with_lse: bool = False,
):
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    acc = _acc(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)).mul_(1.0 / math.sqrt(D))
    if causal:
        tpos = torch.arange(T, device=q.device)
        qpos = torch.arange(S, device=q.device) + (T - S)
        s.masked_fill_(tpos[None, :] > qpos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.to(acc)).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                      block: int = 128, o_lo: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``attention_ref(q, k, v, causal)`` at upstream gradient
    ``do``, given its output ``o`` (plus ``o_lo``, what o's rounding lost,
    where given) and log-sum-exp ``lse`` (B, Hq, S): over
    key blocks of ``block``, P = exp(q k^T / sqrt(D) - lse) (0 where
    masked), dv += P^T do, dP = do v^T, dS = P (dP - Delta), dq += dS k /
    sqrt(D), dk += dS^T q / sqrt(D); GQA's dk and dv summed over each kv
    head's query heads.  Computed in fp32 (float64 for float64), returned
    in the inputs' types."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    acc = _acc(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qf, of, dof = q.to(acc), o.to(acc), do.to(acc)
    kf = k.to(acc).repeat_interleave(G, dim=1)
    vf = v.to(acc).repeat_interleave(G, dim=1)
    lse = lse.to(acc)
    if o_lo is not None:
        of = of + o_lo.to(acc)
    delta = (dof * of).sum(-1)  # (B, Hq, S)
    qpos = torch.arange(S, device=q.device) + (T - S)
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, T, block):
        kb, vb = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        p = torch.exp(torch.matmul(qf, kb.transpose(-1, -2)) * scale - lse[..., None])
        if causal:
            tpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            p = p.masked_fill(tpos[None, :] > qpos[:, None], 0.0)
        dv[:, :, k0:k0 + block] = torch.matmul(p.transpose(-1, -2), dof)
        ds = p * (torch.matmul(dof, vb.transpose(-1, -2)) - delta[..., None])
        dq += torch.matmul(ds, kb) * scale
        dk[:, :, k0:k0 + block] = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.view(B, Hkv, G, T, D).sum(2)
    dv = dv.view(B, Hkv, G, T, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
