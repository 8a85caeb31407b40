"""Optimizers (AdamW / Adafactor / SGD-momentum) + LR schedules, as plain functions.

Written out rather than taken from ``torch.optim`` so each matches the JAX
reference (``repro/train/optim.py``) step for step:

* the learning rate comes from the step *before* the increment;
* ``grad_clip`` (default 1.0) clips by global norm inside ``update``;
* AdamW puts ``wd * p`` inside the lr-scaled step;
* SGD adds ``wd * p`` to the gradient and uses ``beta1`` as its momentum.

Unlike the reference's pure functions, ``update`` works **in place**: it
overwrites the parameter and moment tensors under ``torch.no_grad()`` (the
parameters stay autograd leaves) and returns the same trees.  Adafactor
(factored second moments over the last two dims, no momentum, update
clipping and relative step size) follows ``repro/train/optim.py:88-144``;
``make_optimizer(cfg, view=hwio_view)`` factors the ResNet's OIHW conv
weights over the dims the reference factors in its HWIO layout (input and
output channels), so its moments have the reference's shapes and values.
AdamW and SGD are elementwise and need no view.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.tree import leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (params, opt_state), in place


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    base, warm, total = cfg.learning_rate, cfg.warmup_steps, cfg.total_steps

    def sched(step: int) -> float:
        warm_lr = base * min(1.0, (step + 1) / max(warm, 1))
        if cfg.schedule == "constant":
            return warm_lr
        frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        if cfg.schedule == "linear":
            return warm_lr * (1.0 - frac)
        return warm_lr * 0.5 * (1.0 + math.cos(math.pi * frac))  # cosine

    return sched


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """Scale ``grads`` in place so their global norm is at most ``max_norm``;
    returns (grads, norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale)
    return grads, norm


def _zeros_like(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                               requires_grad=False), params)


def make_adamw(cfg: TrainConfig) -> Optimizer:
    sched = make_schedule(cfg)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

    def init(params):
        return {"mu": _zeros_like(params), "nu": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, step: int):
        grads = list(grads)
        if cfg.grad_clip:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        lr = sched(step)
        t = step + 1.0
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t
        for g, m, v, p in zip(grads, leaves(state["mu"]), leaves(state["nu"]), leaves(params)):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            step_ = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p.float()
            p.sub_((lr * step_).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def hwio_view(t: torch.Tensor) -> torch.Tensor:
    """A 4-D conv weight, OIHW in the port, as the reference's HWIO (a view);
    any other leaf as it is."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def make_adafactor(cfg: TrainConfig, view: Optional[Callable[[torch.Tensor], torch.Tensor]]
                   = None) -> Optimizer:
    """Factored Adafactor (Shazeer & Stern): row/col second moments for >=2-D
    tensors (factored over the last two dims of each leaf's ``view``, the
    leaf itself by default), full for 1-D.  No momentum."""
    sched = make_schedule(cfg)
    eps1, eps2 = 1e-30, 1e-3
    wd = cfg.weight_decay
    view = view or (lambda t: t)

    def init(params):
        def st(p):
            p = view(p)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32, requires_grad=False)}

        return {"v": tree_map(st, params)}

    @torch.no_grad()
    def update(grads, state, params, step: int):
        grads = list(grads)
        if cfg.grad_clip:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        lr = sched(step)
        beta2 = 1.0 - (step + 1.0) ** (-0.8)
        # one {"vr","vc"} or {"v"} dict per parameter, in leaf order
        slots = _slot_dicts(state["v"], params)
        for g, v, p in zip(grads, slots, leaves(params)):
            g, p = view(g).float(), view(p)  # p: a view, updated in place
            g2 = g * g + eps1
            if p.dim() >= 2:
                v["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(-1))
                v["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(-2))
                vr, vc = v["vr"], v["vc"]
                denom = vr[..., None] * vc[..., None, :] / torch.clamp(
                    vr.mean(-1, keepdim=True)[..., None], min=eps1)
                u = g * torch.rsqrt(torch.clamp(denom, min=eps1))
            else:
                v["v"].mul_(beta2).add_((1 - beta2) * g2)
                u = g * torch.rsqrt(torch.clamp(v["v"], min=eps1))
            # update clipping (RMS <= 1)
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)), min=1.0)
            pf = p.float()
            scale = torch.clamp(torch.sqrt(torch.mean(pf * pf)), min=eps2)
            p.copy_((pf - lr * scale * u - lr * wd * pf).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def _slot_dicts(v_tree: Any, params: Any) -> List[Any]:
    """The per-parameter slot dicts of an Adafactor state, in leaf order."""
    if isinstance(params, dict):
        return [s for k in sorted(params) for s in _slot_dicts(v_tree[k], params[k])]
    if isinstance(params, (list, tuple)):
        return [s for i, p in enumerate(params) for s in _slot_dicts(v_tree[i], p)]
    return [v_tree]


def make_sgd(cfg: TrainConfig) -> Optimizer:
    sched = make_schedule(cfg)
    momentum = cfg.beta1

    def init(params):
        return {"m": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, step: int):
        grads = list(grads)
        if cfg.grad_clip:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        lr = sched(step)
        for g, m, p in zip(grads, leaves(state["m"]), leaves(params)):
            g = g.float() + cfg.weight_decay * p.float()
            m.mul_(momentum).add_(g)
            p.sub_((lr * m).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig,
                   view: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> Optimizer:
    """``view``: each leaf in the reference's layout, for the one optimizer
    whose state depends on it (Adafactor's factored dims; ``hwio_view``
    for the ResNet)."""
    if cfg.optimizer == "adamw":
        return make_adamw(cfg)
    if cfg.optimizer == "adafactor":
        return make_adafactor(cfg, view)
    if cfg.optimizer == "sgd":
        return make_sgd(cfg)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
