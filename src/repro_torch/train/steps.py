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

Under the trainer's tracing scope (:func:`repro_torch.core.tracing.step_scope`)
a step records its phases as device spans tagged with the trainer's step:
``step_fwd_bwd`` for each microbatch (``mb``), ``step_grad_reduce`` under a
process group, ``step_optimizer``; every operation the step enqueues lies
in one of them.

``attention_impl="pallas"`` is refused for training: the flash kernel is
forward-only, as the reference's Pallas kernel is (``jax.grad`` through it
fails).  ``make_eval_step`` computes the forward loss with it.

Under a process group (:mod:`repro_torch.launch.dist`, one process a card,
each rank holding its rows of the global batch) the steps are data
parallel and compute what the reference's jit computes over a batch
sharded across devices: after autograd (and the microbatches' sum) the
gradients are flattened into one fp32 buffer, all-reduced once and
divided by the world size (:class:`GradReduce`); *then* the compression
round trip runs, on the global gradient, as the reference's does.  The
metrics are group means, ``grad_norm`` the reduced gradient's norm; the
ResNet's BatchNorm takes the global batch's statistics
(:mod:`repro_torch.models.resnet`).  Every state constructor broadcasts
rank 0's state to every rank.  An MoE batch whose routing groups would
straddle ranks is refused before the step
(:func:`repro_torch.models.moe.check_rank_groups`).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence, Union

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.tracing import (STEP_FWD_BWD, STEP_GRAD_REDUCE, STEP_OPTIMIZER, EventPairs,
                                      phase)
from repro_torch.launch import dist
from repro_torch.models import encdec, moe, resnet, transformer
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
    an LM's or an encoder-decoder's); rank 0's under a process group."""
    state = {"params": params, "opt": make_optimizer(tcfg).init(params), "step": 0}
    if tcfg.grad_compression == "int8_ef":
        state["ef"] = compression.init_error_feedback(params)
    return dist.broadcast_tree_(state)


class GradReduce:
    """The data-parallel gradient reduction: the gradients flattened into
    one fp32 buffer, all-reduced once, divided by the world size and cut
    back into their shapes.  The all-reduce alone is timed (under gloo with
    its staging through the host): on the card between two CUDA events
    that the step never waits for (:class:`~repro_torch.core.tracing.EventPairs`
    reads a pair once it has completed; :attr:`seconds` waits for the
    last), on the CPU by the host's clock.  ``calls``; ``bytes``, the
    buffer's."""

    def __init__(self) -> None:
        self.calls = 0
        self.bytes = 0
        self._seconds = 0.0
        self._pairs = EventPairs(self._add)

    def _add(self, start: Any, end: Any) -> None:
        self._seconds += start.elapsed_time(end) / 1e3

    @property
    def seconds(self) -> float:
        self._pairs.settle(wait=True)
        return self._seconds

    def __call__(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        if flat.is_cuda:
            self._pairs.settle()
            with self._pairs.around(torch.cuda.current_stream(flat.device)):
                dist.all_reduce_(flat)
        else:
            t0 = time.perf_counter()
            dist.all_reduce_(flat)
            self._seconds += time.perf_counter() - t0
        flat.div_(dist.world_size())
        self.calls += 1
        self.bytes += flat.numel() * flat.element_size()
        return [part.view(g.shape).to(g.dtype)
                for g, part in zip(grads, flat.split([g.numel() for g in grads]))]


def _group_means(*metrics: torch.Tensor) -> List[torch.Tensor]:
    """Scalar metrics averaged over the process group, in one all-reduce."""
    return list(dist.group_mean([torch.stack([m.float() for m in metrics])])[0].unbind())


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
            with phase(STEP_FWD_BWD, mb=0):
                return grads_of(params, tree, batch)
        n = next(iter(batch.values())).shape[0]
        if n % M:
            raise ValueError(f"batch of {n} does not split into {M} microbatches")
        gsum = lsum = asum = None
        for i in range(M):
            # the last microbatch's phase holds the division by M too
            with phase(STEP_FWD_BWD, mb=i):
                mb = {k: v[i * (n // M):(i + 1) * (n // M)] for k, v in batch.items()}
                g, loss, aux = grads_of(params, tree, mb)
                if gsum is None:
                    gsum, lsum, asum = [x.float() for x in g], loss, aux
                else:
                    for a, x in zip(gsum, g):
                        a.add_(x.float())
                    lsum, asum = lsum + loss, asum + aux
                del g
                if i == M - 1:
                    for a in gsum:
                        a.div_(M)
                    lsum, asum = lsum / M, asum / M
        return gsum, lsum, asum

    reduce = GradReduce()

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        data_parallel = dist.is_initialized()
        if data_parallel and cfg.moe is not None:
            rows, seq = batch["tokens"].shape[:2]
            moe.check_rank_groups(cfg, rows // M, seq, dist.world_size())
        grads, loss, aux = compute_grads(params, batch)
        if data_parallel:
            with phase(STEP_GRAD_REDUCE):
                grads = reduce(grads)
                loss, aux = _group_means(loss, aux)
        with phase(STEP_OPTIMIZER):
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

    train_step.grad_reduce = reduce
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
    return resnet_train_state(params, bn, tcfg)


def resnet_train_state(params: Any, bn: Any, tcfg: TrainConfig) -> Dict[str, Any]:
    """ResNet train state around existing parameters and BatchNorm
    statistics (for example :func:`repro_torch.convert.resnet_state_from_jax`'s);
    rank 0's under a process group."""
    return dist.broadcast_tree_({
        "params": params,
        "bn": bn,
        "opt": make_optimizer(tcfg, view=hwio_view).init(params),
        "step": 0,
    })


def make_resnet_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    opt = make_optimizer(tcfg, view=hwio_view)
    reduce = GradReduce()

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        with phase(STEP_FWD_BWD, mb=0):
            loss, (new_bn, acc) = resnet.resnet_loss(params, state["bn"], batch, cfg, train=True)
            grads = torch.autograd.grad(loss, leaves(params))
            loss = loss.detach()
        if dist.is_initialized():
            with phase(STEP_GRAD_REDUCE):
                grads = reduce(grads)
                loss, acc = _group_means(loss, acc)
        with phase(STEP_OPTIMIZER):
            gnorm = global_norm(grads)
            opt.update(grads, state["opt"], params, state["step"])
        new_state = dict(state, bn=new_bn, step=state["step"] + 1)
        return new_state, {"loss": loss, "accuracy": acc, "grad_norm": gnorm}

    train_step.grad_reduce = reduce
    return train_step
