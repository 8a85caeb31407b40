"""Parameter counting from shapes alone (the reference's
``repro/models/counting.py``).

``count_params``        — total trainable parameters.
``count_active_params`` — MoE-aware: routed expert tensors (leaves whose
                          path holds ``moe/w_``) scaled by top_k /
                          num_experts (for 6*N_active*D flops).
``model_flops``         — 6*N*D (train) or 2*N*D (inference forward).

The reference traces its ``init_*`` with ``jax.eval_shape``; here the
port's own ``init_*`` runs under ``FakeTensorMode``, whose tensors carry a
shape and a dtype and no storage, so a 341 B-parameter model is counted
without drawing a number.  The generator the ``init_*`` draw from is a CPU
one, and nothing is moved to a card.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.tree import flatten


def _param_shapes(cfg: ModelConfig) -> Any:
    """The parameter tree of ``cfg``'s family, as fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import encdec, resnet, transformer

    generator = torch.Generator()
    with FakeTensorMode():
        if cfg.family == "resnet":
            return resnet.init_resnet(cfg, generator, "cpu")[0]
        if cfg.family == "encdec":
            return encdec.init_encdec(cfg, generator, "cpu")
        return transformer.init_lm(cfg, generator, "cpu")


@lru_cache(maxsize=64)
def _counts(cfg: ModelConfig) -> Tuple[int, int]:
    frac = cfg.moe.top_k / cfg.moe.num_experts if cfg.moe is not None else 1.0
    total, active = 0, 0.0
    for path, leaf in flatten(_param_shapes(cfg)).items():
        n = leaf.numel()
        total += n
        active += n * frac if "moe/w_" in path else n
    return total, int(active)


def count_params(cfg: ModelConfig) -> int:
    return _counts(cfg)[0]


def count_active_params(cfg: ModelConfig) -> int:
    return _counts(cfg)[1]


def model_flops(cfg: ModelConfig, tokens: int, kind: str = "train") -> float:
    """6*N*D (train) or 2*N*D (inference fwd) with MoE-active N."""
    n = count_active_params(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
