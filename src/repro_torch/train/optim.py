"""Optimizers (AdamW / SGD-momentum) + LR schedules, as plain functions.

Written out rather than taken from ``torch.optim`` so each matches the JAX
reference (``repro/train/optim.py``) step for step:

* the learning rate comes from the step *before* the increment;
* ``grad_clip`` (default 1.0) clips by global norm inside ``update``;
* AdamW puts ``wd * p`` inside the lr-scaled step;
* SGD adds ``wd * p`` to the gradient and uses ``beta1`` as its momentum.

Unlike the reference's pure functions, ``update`` works **in place**: it
overwrites the parameter and moment tensors under ``torch.no_grad()`` (the
parameters stay autograd leaves) and returns the same trees.  Adafactor
comes with the LM slice.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

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


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return make_adamw(cfg)
    if cfg.optimizer == "sgd":
        return make_sgd(cfg)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}; the port has adamw and sgd")
