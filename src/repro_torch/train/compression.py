"""Gradient compression for the data-parallel reduction (the reference's
``repro/train/compression.py``).

Models the wire format of the gradient reduction: ``bf16`` halves its bytes;
``int8_ef`` quarters them with per-tensor scaling and error feedback (the
quantization residual is carried to the next step, so the scheme is
unbiased in the long run).  The round trip wraps the gradients inside the
train step; on one card there is no reduction, so what the tests hold is the
arithmetic.  Gradients and error-feedback state are lists of tensors in leaf
order (:func:`repro_torch.tree.leaves`).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_map


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32, requires_grad=False),
                    params)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def apply_compression(grads: Sequence[torch.Tensor], ef: Optional[Sequence[torch.Tensor]],
                      mode: str) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    """Returns (effective grads after the simulated wire round trip, new ef)."""
    if mode == "none":
        return list(grads), None if ef is None else list(ef)
    if mode == "bf16":
        return [g.to(torch.bfloat16).float() for g in grads], None if ef is None else list(ef)
    if mode == "int8_ef":
        if ef is None:
            raise ValueError("int8_ef requires error-feedback state")
        out, new_ef = [], []
        for g, e in zip(grads, ef):
            g = g.float() + e
            deq = decompress_int8(*compress_int8(g))
            out.append(deq)
            new_ef.append(g - deq)
        return out, new_ef
    raise ValueError(f"unknown compression mode {mode!r}")
