"""The optimizers a configuration states, written plainly, in float32.

Both clip the gradients to a global norm of ``grad_clip`` first.  The
learning rate of step s (counted from 0) is ``lr * min(1, (s+1)/warmup)``
times a cosine decay that starts after the warmup.  SGD adds the weight
decay to the gradient and keeps ``m = momentum*m + g``; AdamW puts the
decay inside the step, ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def learning_rate(opt: Dict, step: int) -> float:
    warm, total = opt["warmup_steps"], opt["total_steps"]
    lr = opt["learning_rate"] * min(1.0, (step + 1) / max(warm, 1))
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * frac))


def clip(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g.float() * scale for g in grads]


def init_state(opt: Dict, params: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    moments = ("m",) if opt["name"] == "sgd" else ("m", "v")
    return {k: {p: torch.zeros_like(t) for p, t in params.items()} for k in moments}


@torch.no_grad()
def update(opt: Dict, state: Dict, params: Dict[str, torch.Tensor],
           grads: Dict[str, torch.Tensor], step: int) -> None:
    """One step in place; ``state["m"]`` afterwards holds the first moment."""
    names = list(params)
    clipped = dict(zip(names, clip([grads[n] for n in names], opt["grad_clip"])))
    lr, wd = learning_rate(opt, step), opt["weight_decay"]
    for n in names:
        p, g, m = params[n], clipped[n], state["m"][n]
        if opt["name"] == "sgd":
            m.mul_(opt["momentum"]).add_(g + wd * p)
            p.sub_(lr * m)
        else:
            b1, b2, t = opt["beta1"], opt["beta2"], step + 1.0
            v = state["v"][n]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lr * ((m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + opt["eps"]) + wd * p))
