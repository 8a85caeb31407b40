"""Plain PyTorch version of the RWKV-6 WKV recurrence (sequential scan), the
twin of the reference's ``wkv_ref`` oracle:

    y_t = r_t . S_{t-1} + (r_t . (u*k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The same arithmetic as the kernel in ``csrc/wkv.cu``, one token at a time.
"""
import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, s0: torch.Tensor):
    """r,k,v,w: (BH, S, D) fp32; u: (BH, D); s0: (BH, D, D).
    Returns y (BH, S, D), sT (BH, D, D)."""
    s = s0
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # (BH, D)
        bonus = torch.einsum("bk,bk->b", r_t, u * k_t)
        ys.append(torch.einsum("bk,bkv->bv", r_t, s) + bonus[:, None] * v_t)
        s = w_t[..., None] * s + torch.einsum("bk,bv->bkv", k_t, v_t)
    return torch.stack(ys, dim=1), s


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: torch.Tensor):
    """:func:`wkv_ref` in the wrapper's layout: r,k,v,w (B,S,H,D), u (H,D),
    s0 (B,H,D,D) -> y (B,S,H,D), sT (B,H,D,D)."""
    B, S, H, D = r.shape
    to_bh = lambda a: a.transpose(1, 2).reshape(B * H, S, D)  # noqa: E731
    ub = u[None].expand(B, H, D).reshape(B * H, D)
    y, sT = wkv_ref(to_bh(r), to_bh(k), to_bh(v), to_bh(w), ub, s0.reshape(B * H, D, D))
    return y.reshape(B, H, S, D).transpose(1, 2), sT.reshape(B, H, D, D)
