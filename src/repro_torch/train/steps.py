"""ResNet train step (BatchNorm state threads through the step).

``make_resnet_train_step(cfg, tcfg)`` builds::

    train_step(state, batch) -> (state, metrics)

Gradients come from autograd; the optimizer updates parameters and moments
in place (:mod:`repro_torch.train.optim`).  ``state["step"]`` is a host int.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models import resnet
from repro_torch.train.optim import global_norm, make_optimizer
from repro_torch.tree import leaves


def init_resnet_train_state(cfg: ModelConfig, tcfg: TrainConfig, generator: torch.Generator,
                            device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    params, bn = resnet.init_resnet(cfg, generator, device)
    for p in leaves(params):
        p.requires_grad_(True)
    return {
        "params": params,
        "bn": bn,
        "opt": make_optimizer(tcfg).init(params),
        "step": 0,
    }


def make_resnet_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    opt = make_optimizer(tcfg)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        loss, (new_bn, acc) = resnet.resnet_loss(params, state["bn"], batch, cfg, train=True)
        grads = torch.autograd.grad(loss, leaves(params))
        gnorm = global_norm(grads)
        opt.update(grads, state["opt"], params, state["step"])
        new_state = dict(state, bn=new_bn, step=state["step"] + 1)
        return new_state, {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm}

    return train_step
