"""ResNet (He et al. 2015, basic blocks), plainly, over ``{path: tensor}``.

Convolutions are OIHW with "SAME" padding (the extra pixel at the end, as
XLA pads); BatchNorm in training normalizes by the batch's biased
variance, eps 1e-5, and moves its running statistics 1/10 of the way to
the batch's (the biased variance there too); a 3x3/2 max-pool after the
stem; global average pool; ``logits = h @ fc/w + fc/b``; mean
cross-entropy.  ``dtype`` is the arithmetic's: float32 is the reference,
bfloat16 the control.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]


def _pad(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    return F.conv2d(_pad(x, w.shape[-1], stride), w.to(x.dtype), stride=stride)


def _bn(x: torch.Tensor, P: Tensors, S: Tensors, new_s: Tensors, name: str) -> torch.Tensor:
    mean = x.mean((0, 2, 3))
    var = (x - mean[None, :, None, None]).square().mean((0, 2, 3))
    new_s[f"{name}/mean"] = 0.9 * S[f"{name}/mean"] + 0.1 * mean.detach().float()
    new_s[f"{name}/var"] = 0.9 * S[f"{name}/var"] + 0.1 * var.detach().float()
    y = (x - mean[None, :, None, None]) * torch.rsqrt(var + 1e-5)[None, :, None, None]
    return (y * P[f"{name}/scale"].to(x.dtype)[None, :, None, None]
            + P[f"{name}/bias"].to(x.dtype)[None, :, None, None])


def loss(cfg: Dict, P: Tensors, S: Tensors, image: torch.Tensor, label: torch.Tensor,
         dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, Tensors]:
    """(mean cross-entropy, new BatchNorm statistics)."""
    new_s: Tensors = {}
    h = _conv(image.to(dtype), P["stem/conv/w"], 2)
    h = F.relu(_bn(h, P, S, new_s, "stem/bn"))
    h = F.max_pool2d(_pad(h, 3, 2, float("-inf")), 3, 2)
    width = cfg["resnet_width"]
    cin = width
    for si, n in enumerate(cfg["resnet_blocks"]):
        cout = width * 2**si
        for bi in range(n):
            p = f"stage{si}/{bi}"
            stride = 2 if (si > 0 and bi == 0) else 1
            y = F.relu(_bn(_conv(h, P[f"{p}/conv1/w"], stride), P, S, new_s, f"{p}/bn1"))
            y = _bn(_conv(y, P[f"{p}/conv2/w"], 1), P, S, new_s, f"{p}/bn2")
            if stride != 1 or cin != cout:
                h = _bn(_conv(h, P[f"{p}/proj/w"], stride), P, S, new_s, f"{p}/bn_proj")
            h = F.relu(y + h)
            cin = cout
    logits = (h.mean((2, 3)) @ P["fc/w"].to(dtype) + P["fc/b"].to(dtype)).float()
    ce = torch.logsumexp(logits, -1) - logits.gather(1, label.long()[:, None])[:, 0]
    return ce.mean(), new_s
