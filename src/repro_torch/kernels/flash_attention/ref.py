"""Plain PyTorch version of ``flash_attention``: dense scores in fp32.

The same function as the kernels in ``csrc/flash_attention.cu`` and
``csrc/flash_attention_sm90.cu`` (and the reference's ``flash_attention``
wrapper): inputs upcast to fp32, scale
``1/sqrt(D)``, causal mask with ``q_offset = T - S`` and masked scores at
``-1e30``, fp32 softmax and ``p @ v``, output cast back to ``q.dtype``.  GQA
reads kv head ``h // (Hq // Hkv)``.  O(S*T) memory: it is the oracle the
kernel is held to, not a path the model takes on a card.
"""
import math

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    causal: bool = True,
) -> torch.Tensor:
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(1.0 / math.sqrt(D))
    if causal:
        tpos = torch.arange(T, device=q.device)
        qpos = torch.arange(S, device=q.device) + (T - S)
        s.masked_fill_(tpos[None, :] > qpos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)
