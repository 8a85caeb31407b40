"""Initial weights, drawn by the benchmark from ``--seed`` on the device.

One ``torch.randn`` over every random leaf, cut into views and scaled a
leaf at a time; norm scales are ones.  The same seed on the same device
gives the same bits, so the reference draws the weights again after the
window instead of keeping a copy.  Leaves are named by the program's
``/``-joined tree paths; the scheme of each is the program's own
(He-normal convolutions, N(0, 0.01) classifier, N(0, 1/fan-in) dense
layers, N(0, 0.02) embedding), so the run trains from a realistic start.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (path, shape, std); std None: ones, 0.0: zeros
Leaf = Tuple[str, Tuple[int, ...], object]


def resnet_leaves(cfg: Dict) -> Tuple[List[Leaf], List[Leaf]]:
    """Parameters and BatchNorm statistics of the ResNet."""
    w = cfg["resnet_width"]
    params: List[Leaf] = []
    stats: List[Leaf] = []

    def conv(path: str, k: int, cin: int, cout: int) -> None:
        params.append((path, (cout, cin, k, k), math.sqrt(2.0 / (k * k * cin))))

    def bn(path: str, c: int) -> None:
        params.extend([(f"{path}/bias", (c,), 0.0), (f"{path}/scale", (c,), None)])
        stats.extend([(f"{path}/mean", (c,), 0.0), (f"{path}/var", (c,), None)])

    conv("stem/conv/w", 7, 3, w)
    bn("stem/bn", w)
    cin = w
    for si, n in enumerate(cfg["resnet_blocks"]):
        cout = w * 2**si
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            p = f"stage{si}/{bi}"
            bn(f"{p}/bn1", cout)
            bn(f"{p}/bn2", cout)
            if stride != 1 or cin != cout:
                bn(f"{p}/bn_proj", cout)
            conv(f"{p}/conv1/w", 3, cin, cout)
            conv(f"{p}/conv2/w", 3, cout, cout)
            if stride != 1 or cin != cout:
                conv(f"{p}/proj/w", 1, cin, cout)
            cin = cout
    params.extend([("fc/b", (cfg["num_classes"],), 0.0),
                   ("fc/w", (cin, cfg["num_classes"]), 0.01)])
    return params, stats


def decoder_leaves(cfg: Dict) -> List[Leaf]:
    """Parameters of the dense decoder, block leaves stacked over layers."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    L, hd = cfg["num_hidden_layers"], cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    b = "blocks/sub0"
    out: List[Leaf] = [
        (f"{b}/attn/wk", (L, d, kv, hd), d ** -0.5),
        (f"{b}/attn/wo", (L, h, hd, d), (h * hd) ** -0.5),
        (f"{b}/attn/wq", (L, d, h, hd), d ** -0.5),
        (f"{b}/attn/wv", (L, d, kv, hd), d ** -0.5),
        (f"{b}/ln1/scale", (L, d), None),
        (f"{b}/ln2/scale", (L, d), None),
        (f"{b}/mlp/w_down", (L, f, d), f ** -0.5),
        (f"{b}/mlp/w_gate", (L, d, f), d ** -0.5),
        (f"{b}/mlp/w_up", (L, d, f), d ** -0.5),
        ("embed/w", (v, d), 0.02),
        ("final_norm/scale", (d,), None),
    ]
    if not cfg.get("tie_word_embeddings"):
        out.append(("lm_head/w", (d, v), d ** -0.5))
    return out


def draw(leaves: List[Leaf], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """``{path: float32 tensor}``; every random leaf a view of one draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    total = sum(math.prod(s) for _, s, std in leaves if isinstance(std, float) and std > 0)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for path, shape, std in leaves:
        if std is None:
            out[path] = torch.ones(shape, device=device)
        elif std == 0.0:
            out[path] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[path] = flat[off:off + n].view(shape).mul_(std)
            off += n
    return out
