"""Plain PyTorch version of fused RMSNorm, the twin of the reference's
``rmsnorm_ref`` oracle (and of ``apply_norm``'s rmsnorm branch)."""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,).  fp32 accumulation, output in x.dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
