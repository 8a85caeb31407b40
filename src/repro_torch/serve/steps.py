"""Serving programs: prefill / decode per architecture family, and the
samplers (the reference's ``repro/serve/steps.py``)."""
from __future__ import annotations

from typing import Callable, Dict, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer


def make_serve_fns(cfg: ModelConfig, device: Union[str, torch.device] = "cuda"
                   ) -> Dict[str, Callable]:
    """Returns dict(init_cache, prefill, decode) for the family: the
    encoder-decoder, or the LM (dense, MLA, MoE, VLM, RWKV and hybrid);
    caches are made on ``device``."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return {
            "init_cache": lambda batch, max_len: encdec.init_dec_cache(cfg, batch, max_len, dev),
            "prefill": lambda params, batch, cache: encdec.prefill(params, batch, cfg, cache),
            "decode": lambda params, cache, tok, pos: encdec.decode_step(
                params, cache, tok, pos, cfg),
        }
    return {
        "init_cache": lambda batch, max_len: transformer.init_cache(cfg, batch, max_len, dev),
        "prefill": lambda params, batch, cache: transformer.prefill(params, batch, cfg, cache),
        "decode": lambda params, cache, tok, pos: transformer.decode_step(
            params, cache, tok, pos, cfg),
    }


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The first index of the largest logit a row, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(logits: torch.Tensor, generator: torch.Generator,
                       temperature: float = 1.0) -> torch.Tensor:
    """One draw a row from softmax(logits / temperature); ``generator`` (on
    the logits' device) takes the place of the reference's JAX key."""
    probs = torch.softmax(logits.float() / max(temperature, 1e-5), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
