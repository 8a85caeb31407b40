"""Train and eval steps: the LM and the encoder-decoder with microbatch
accumulation and gradient compression, and the ResNet (BatchNorm state
threads through the step).

``make_train_step(cfg, tcfg)`` and ``make_resnet_train_step(cfg, tcfg)`` build::

    train_step(state, batch) -> (state, metrics)

Gradients come from autograd; the optimizer updates parameters and moments
in place (:mod:`repro_torch.train.optim`).  ``state["step"]`` is a host int.
For the LM, as in ``repro/train/steps.py``:

* loss = model loss + aux loss (the MoE load-balancing loss summed over
  layers; zero for a model without MoE layers), both in the metrics as
  ``loss`` and ``aux_loss``;
* ``microbatches > 1`` splits the batch along its leading dim and sums the
  microbatches' gradients in fp32, then divides by their count;
* the gradients then take the compression round trip (none / bf16 /
  int8 with error feedback, whose state lives in ``state["ef"]``) before the
  optimizer.

``attention_impl="pallas"`` is refused for training: the flash kernel is
forward-only, as the reference's Pallas kernel is (``jax.grad`` through it
fails).  ``make_eval_step`` computes the forward loss with it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models import encdec, resnet, transformer
from repro_torch.train import compression
from repro_torch.train.optim import global_norm, hwio_view, make_optimizer
from repro_torch.tree import leaves


def loss_fn_for(cfg: ModelConfig) -> Callable:
    if cfg.family == "encdec":
        return lambda p, b: encdec.forward_train(p, b, cfg)
    if cfg.family == "resnet":
        raise ValueError("use make_resnet_train_step for the resnet family")
    return lambda p, b: transformer.forward_train(p, b, cfg)


def init_params_for(cfg: ModelConfig, generator: torch.Generator,
                    device: Union[str, torch.device] = "cuda") -> Any:
    if cfg.family == "encdec":
        return encdec.init_encdec(cfg, generator, device)
    if cfg.family == "resnet":
        return resnet.init_resnet(cfg, generator, device)[0]
    return transformer.init_lm(cfg, generator, device)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, generator: torch.Generator,
                     device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    params = init_params_for(cfg, generator, device)
    for p in leaves(params):
        p.requires_grad_(True)
    return lm_train_state(params, tcfg)


def lm_train_state(params: Any, tcfg: TrainConfig) -> Dict[str, Any]:
    """Train state around existing parameters (for example ones converted
    from the reference with :func:`repro_torch.convert.lm_params_from_jax`,
    an LM's or an encoder-decoder's)."""
    state = {"params": params, "opt": make_optimizer(tcfg).init(params), "step": 0}
    if tcfg.grad_compression == "int8_ef":
        state["ef"] = compression.init_error_feedback(params)
    return state


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    if cfg.attention_impl == "pallas":
        raise ValueError(
            "attention_impl='pallas' is forward-only (the flash kernel has no backward, "
            "as the reference's Pallas kernel has no VJP): train with 'ref' and use "
            "make_eval_step for the flash forward loss")
    opt = make_optimizer(tcfg)
    loss_fn = loss_fn_for(cfg)
    M = max(tcfg.microbatches, 1)

    def grads_of(params: List[torch.Tensor], tree: Any, batch: Dict[str, torch.Tensor]):
        loss, aux = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss + aux, params)
        return grads, loss.detach(), aux.detach()

    def compute_grads(tree: Any, batch: Dict[str, torch.Tensor]):
        params = leaves(tree)
        if M == 1:
            return grads_of(params, tree, batch)
        n = next(iter(batch.values())).shape[0]
        if n % M:
            raise ValueError(f"batch of {n} does not split into {M} microbatches")
        gsum = lsum = asum = None
        for i in range(M):
            mb = {k: v[i * (n // M):(i + 1) * (n // M)] for k, v in batch.items()}
            g, loss, aux = grads_of(params, tree, mb)
            if gsum is None:
                gsum, lsum, asum = [x.float() for x in g], loss, aux
            else:
                for a, x in zip(gsum, g):
                    a.add_(x.float())
                lsum, asum = lsum + loss, asum + aux
            del g
        for a in gsum:
            a.div_(M)
        return gsum, lsum / M, asum / M

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        grads, loss, aux = compute_grads(params, batch)
        ef = leaves(state["ef"]) if "ef" in state else None
        grads, new_ef = compression.apply_compression(grads, ef, tcfg.grad_compression)
        if new_ef is not None:
            with torch.no_grad():
                for e, n_ in zip(ef, new_ef):
                    e.copy_(n_)
        gnorm = global_norm(grads)
        opt.update(grads, state["opt"], params, state["step"])
        new_state = dict(state, step=state["step"] + 1)
        return new_state, {"loss": loss, "aux_loss": aux, "grad_norm": gnorm}

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = loss_fn_for(cfg)

    @torch.no_grad()
    def eval_step(params: Any, batch: Dict[str, torch.Tensor]):
        loss, aux = loss_fn(params, batch)
        return {"loss": loss, "aux_loss": aux}

    return eval_step


# -- resnet (BatchNorm state threads through) --------------------------------


def init_resnet_train_state(cfg: ModelConfig, tcfg: TrainConfig, generator: torch.Generator,
                            device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    params, bn = resnet.init_resnet(cfg, generator, device)
    for p in leaves(params):
        p.requires_grad_(True)
    return {
        "params": params,
        "bn": bn,
        "opt": make_optimizer(tcfg, view=hwio_view).init(params),
        "step": 0,
    }


def make_resnet_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    opt = make_optimizer(tcfg, view=hwio_view)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        loss, (new_bn, acc) = resnet.resnet_loss(params, state["bn"], batch, cfg, train=True)
        grads = torch.autograd.grad(loss, leaves(params))
        gnorm = global_norm(grads)
        opt.update(grads, state["opt"], params, state["step"])
        new_state = dict(state, bn=new_bn, step=state["step"] + 1)
        return new_state, {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm}

    return train_step
