"""Frozen arithmetic of the yardstick: model FLOPs, kernel bytes, the card's peaks.

Each piece is written out here, in closed form from published shapes, so
that a change to the program's own counters (``launch/op_cost.py``,
``launch/roofline.py``, a kernel's ``ops.cost``) cannot move a metric.
Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the 700 W limit.
# The card's own power limit is printed beside every reading (device.power_limit_w).
PEAK_FLOPS = {
    "bf16": 989.4e12,
    "tf32": 494.7e12,
    "fp32": 66.9e12,
}
PEAK_HBM_BYTES_PER_S = 3.35e12


def _same_out(n: int, stride: int) -> int:
    """Output length of a "SAME"-padded convolution or pooling window."""
    return -(-n // stride)


def resnet_forward_macs(blocks: Sequence[int], width: int, num_classes: int,
                        image_size: int) -> int:
    """Multiply-adds of one image's forward pass through ResNet (He et al.
    2015, basic blocks): the convolutions and the classifier only, at the
    published layer shapes with "SAME" padding.  BatchNorm, ReLU, pooling
    and the residual adds are left out: they are not model FLOPs.

    ResNet-18 at 224: 1.814e9, torchvision's published 1.81 GMACs."""
    side = _same_out(image_size, 2)  # 7x7/2 stem
    macs = side * side * width * 3 * 49
    side = _same_out(side, 2)  # 3x3/2 max-pool
    cin = width
    for si, n in enumerate(blocks):
        cout = width * 2**si
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            side_out = _same_out(side, stride)
            macs += side_out * side_out * cout * cin * 9  # conv1, 3x3
            macs += side_out * side_out * cout * cout * 9  # conv2, 3x3
            if stride != 1 or cin != cout:
                macs += side_out * side_out * cout * cin  # 1x1 projection
            side, cin = side_out, cout
    return macs + cin * num_classes


def resnet_train_flops_per_image(cfg: Dict) -> float:
    """Model FLOPs of one image's training step: 2 FLOPs a multiply-add,
    and the backward pass twice the forward (3x in all)."""
    return 3 * 2 * resnet_forward_macs(cfg["resnet_blocks"], cfg["resnet_width"],
                                       cfg["num_classes"], cfg["image_size"])


def decoder_params(cfg: Dict) -> int:
    """Every parameter of a dense GQA decoder with a SwiGLU MLP, RMSNorm
    scales and an untied output head (granite-8b-code's layout)."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hd = cfg["head_dim"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    layer = d * q + 2 * d * kv + q * d + 3 * d * f + 2 * d
    head = 0 if cfg.get("tie_word_embeddings") else d * v
    return v * d + cfg["num_hidden_layers"] * layer + d + head


def decoder_train_flops_per_token(cfg: Dict, seq_len: int) -> float:
    """PaLM (Chowdhery et al. 2022), appendix B: 6N + 12 L H Q T model FLOPs
    a trained token, N all parameters, T the sequence length.  Attention is
    counted whole, as the formula does, not halved for the causal mask."""
    return (6 * decoder_params(cfg)
            + 12 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * cfg["head_dim"] * seq_len)


def ingest_norm_bytes(batch: int, height: int, width: int, channels: int = 3,
                      out_bytes: int = 4) -> int:
    """The least traffic of u8 (B,H,W,C) -> normalized (B,C,H,W): each input
    byte read once and each output element written once."""
    return batch * height * width * channels * (1 + out_bytes)


def roofline_pct(flops: float, nbytes: float, seconds: float, peak_flops: float) -> float:
    """The least time the card could take (the larger of the compute and the
    memory bound) as a share of the measured time, in percent."""
    bound = max(flops / peak_flops, nbytes / PEAK_HBM_BYTES_PER_S)
    return 100.0 * bound / seconds
