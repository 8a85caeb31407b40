"""ResNet-18 (the paper's own benchmark model) in PyTorch, NCHW.

Plain functions over a parameter tree of nested dicts and lists, laid out as
the JAX reference's (``repro/models/resnet.py``) so that both packages can
start from the same weights (:mod:`repro_torch.convert`).  Two differences of
layout: conv weights are OIHW here (HWIO in JAX); ``fc/w`` stays (cin,
classes) in both.  BatchNorm carries running statistics in a separate
``state`` tree: ``apply_resnet(params, state, x, cfg, train=True)`` ->
(logits, new_state).

Convolutions and pooling are ``torch.nn.functional`` ops: they were never
Pallas kernels in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import dist

Params = Dict[str, Any]
BN_MOMENTUM = 0.9


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding along one axis: uneven, with the extra pixel at
    the end — (2,3) for the 7x7/2 stem at 224, (0,1) for 3x3/2, none for 1x1/2."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int, value: float = 0.0) -> torch.Tensor:
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    kh, kw = w.shape[2], w.shape[3]
    return F.conv2d(_pad_same(x, kh, kw, stride), w, stride=stride)


class _GroupSum(torch.autograd.Function):
    """A sum over the process group whose forward and backward are both an
    all-reduce: each rank's loss reaches, through the global statistics,
    the rows of every rank that made them."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return dist.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return dist.all_reduce_(g.clone())


def _global_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of the global batch, each rank
    holding its rows.  Each rank takes its rows' count, mean and sum of
    squared deviations (two passes, as ``x.var`` does) into its own row of
    a (world, 2C + 1) buffer of zeros; one all-reduce of that buffer gives
    every rank every rank's moments, merged as Chan et al.'s parallel
    variance: ``M2 = sum M2_r + sum n_r (mean_r - mean)^2``.  No difference
    of two large sums, so the variance cannot cancel below zero."""
    c = x.shape[1]
    n = float(x.numel() // c)
    mean_r = x.mean((0, 2, 3))
    m2_r = (x - mean_r[None, :, None, None]).square().sum((0, 2, 3))
    row = torch.cat([mean_r, m2_r, x.new_full((1,), n)])
    slot = torch.zeros(dist.world_size(), 1, dtype=x.dtype, device=x.device)
    slot[dist.rank()] = 1.0
    moments = _GroupSum.apply(slot * row)  # (world, 2C + 1): every rank's row
    means, m2s, counts = moments[:, :c], moments[:, c:2 * c], moments[:, 2 * c:]
    total = counts.sum()
    mean = (counts * means).sum(0) / total
    m2 = m2s.sum(0) + (counts * (means - mean).square()).sum(0)
    return mean, m2 / total


def _bn(x: torch.Tensor, p: Params, s: Params, train: bool):
    if not train:
        mean, var, new_s = s["mean"], s["var"], s
    else:
        if dist.world_size() > 1:
            # data parallel: the global batch's statistics, as the
            # reference's jit computes them over a batch sharded across
            # devices (running statistics then update alike on every rank)
            mean, var = _global_moments(x)
        else:
            mean = x.mean((0, 2, 3))
            # the reference keeps the *biased* batch variance, also in the
            # running update; F.batch_norm would use the unbiased one there
            var = x.var((0, 2, 3), correction=0)
        new_s = {
            "mean": (BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean).detach(),
            "var": (BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var).detach(),
        }
    inv = torch.rsqrt(var + 1e-5)
    y = (x - mean[None, :, None, None]) * inv[None, :, None, None]
    return y * p["scale"][None, :, None, None] + p["bias"][None, :, None, None], new_s


def _blocks(cfg: ModelConfig) -> Tuple[int, ...]:
    return cfg.resnet_blocks or (2, 2, 2, 2)


def init_resnet(
    cfg: ModelConfig, generator: torch.Generator, device: Union[str, torch.device] = "cuda"
) -> Tuple[Params, Params]:
    """He-normal convs, N(0, 0.01) classifier.  Drawn on the CPU from
    ``generator`` and then moved, so a seed gives the same weights on any
    device."""
    dev = resolve_device(device)

    def normal(*shape: int, std: float) -> torch.Tensor:
        return (torch.randn(*shape, generator=generator) * std).to(dev)

    def conv_w(k: int, cin: int, cout: int) -> torch.Tensor:
        return normal(cout, cin, k, k, std=math.sqrt(2.0 / (k * k * cin)))

    def bn_p(c: int) -> Params:
        return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}

    def bn_s(c: int) -> Params:
        return {"mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)}

    w = cfg.resnet_width
    params: Params = {"stem": {"conv/w": conv_w(7, 3, w), "bn": bn_p(w)}}
    state: Params = {"stem": {"bn": bn_s(w)}}
    cin = w
    for si, n in enumerate(_blocks(cfg)):
        cout = w * (2**si)
        stage_p, stage_s = [], []
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            bp = {
                "conv1/w": conv_w(3, cin, cout),
                "bn1": bn_p(cout),
                "conv2/w": conv_w(3, cout, cout),
                "bn2": bn_p(cout),
            }
            bs = {"bn1": bn_s(cout), "bn2": bn_s(cout)}
            if stride != 1 or cin != cout:
                bp["proj/w"] = conv_w(1, cin, cout)
                bp["bn_proj"] = bn_p(cout)
                bs["bn_proj"] = bn_s(cout)
            stage_p.append(bp)
            stage_s.append(bs)
            cin = cout
        params[f"stage{si}"] = stage_p
        state[f"stage{si}"] = stage_s
    params["fc"] = {
        "w": normal(cin, cfg.num_classes, std=0.01),
        "b": torch.zeros(cfg.num_classes, device=dev),
    }
    return params, state


def apply_resnet(
    params: Params, state: Params, x: torch.Tensor, cfg: ModelConfig, train: bool = True
) -> Tuple[torch.Tensor, Params]:
    """x: (B, 3, H, W) float32."""
    new_state: Params = {"stem": {}}
    h = _conv(x, params["stem"]["conv/w"], stride=2)
    h, new_state["stem"]["bn"] = _bn(h, params["stem"]["bn"], state["stem"]["bn"], train)
    h = F.relu(h)
    # 3x3/2 max-pool, "SAME" with -inf padding
    h = F.max_pool2d(_pad_same(h, 3, 3, 2, value=float("-inf")), 3, 2)
    for si, n in enumerate(_blocks(cfg)):
        stage_state = []
        for bi in range(n):
            bp = params[f"stage{si}"][bi]
            bs = state[f"stage{si}"][bi]
            nbs = {}
            stride = 2 if (si > 0 and bi == 0) else 1
            resid = h
            y = _conv(h, bp["conv1/w"], stride)
            y, nbs["bn1"] = _bn(y, bp["bn1"], bs["bn1"], train)
            y = F.relu(y)
            y = _conv(y, bp["conv2/w"], 1)
            y, nbs["bn2"] = _bn(y, bp["bn2"], bs["bn2"], train)
            if "proj/w" in bp:
                resid = _conv(resid, bp["proj/w"], stride)
                resid, nbs["bn_proj"] = _bn(resid, bp["bn_proj"], bs["bn_proj"], train)
            h = F.relu(y + resid)
            stage_state.append(nbs)
        new_state[f"stage{si}"] = stage_state
    h = h.mean((2, 3))  # global average pool
    logits = h @ params["fc"]["w"] + params["fc"]["b"]
    return logits, new_state


def resnet_loss(params: Params, state: Params, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig, train: bool = True):
    """Mean cross-entropy; returns (loss, (new_state, accuracy)).

    A label outside ``[0, num_classes)`` reads as NaN, as the reference's
    ``take_along_axis`` (fill mode) reads it: the loss is NaN and that row
    adds nothing to the gradient."""
    logits, new_state = apply_resnet(params, state, batch["image"], cfg, train)
    labels = batch["label"].long()
    logz = torch.logsumexp(logits, -1)
    valid = (labels >= 0) & (labels < logits.shape[-1])
    gold = logits.gather(1, labels.clamp(0, logits.shape[-1] - 1)[:, None])[:, 0]
    gold = torch.where(valid, gold, torch.full_like(gold, float("nan")))
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, (new_state, acc)
