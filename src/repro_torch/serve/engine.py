"""Batched serving engine with continuous batching ("-lite"), the
reference's ``repro/serve/engine.py``.

Fixed pool of B slots over a shared KV cache.  Each engine tick decodes one
token for every slot (one ``decode_step`` with per-slot positions).  When a
slot finishes (EOS / max tokens), the next queued request is prefilled into
that slot (batch-1 prefill, scattered into the pooled cache) without
stalling the other slots: the serving analogue of the paper's "keep the
workers busy" principle.

Positions and last tokens are host numpy arrays, as in the reference; a
tick's (B,) tensors are built from them, so no position is read back from
the device.  Everything that touches the model runs under
``torch.inference_mode``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig, ServeSpec
from repro_torch.device import resolve_device
from repro_torch.serve.steps import greedy_sample, make_serve_fns
from repro_torch.tree import leaves


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


class ServeEngine:
    """Sizing comes from a :class:`repro_torch.config.ServeSpec` only (the
    reference's flat ``num_slots=``/``max_len=`` shim is left out: a new
    package has no callers of it to migrate)."""

    def __init__(self, cfg: ModelConfig, params: Any, *, spec: Optional[ServeSpec] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.cfg = cfg
        self.params = params
        self.spec = spec if spec is not None else ServeSpec()
        self.num_slots = self.spec.num_slots
        self.max_len = self.spec.max_len
        self.device = resolve_device(device)
        fns = make_serve_fns(cfg, self.device)
        self._init_cache = fns["init_cache"]
        # slot-0 prefill program (batch 1) + pooled decode program
        self._prefill1 = fns["prefill"]
        self._decode = fns["decode"]
        with torch.inference_mode():
            self.cache = self._init_cache(self.num_slots, self.max_len)
        self.positions = np.zeros((self.num_slots,), np.int32)
        self.last_token = np.zeros((self.num_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * self.num_slots
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self._uid = 0
        self.ticks = 0
        self.tokens_generated = 0

    # -- request API -----------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> int:
        self._uid += 1
        req = Request(
            self._uid, np.asarray(prompt, np.int32), max_new_tokens, eos_id,
            t_submit=time.monotonic(),
        )
        self.queue.append(req)
        return self._uid

    # -- internals ---------------------------------------------------------------
    def _scatter_cache(self, slot: int, cache1: Any) -> None:
        """Write a batch-1 cache into row ``slot`` of the pooled cache: every
        leaf, the whole row (stale k/v past the prompt in a reused slot are
        masked by ``kv_len``; RWKV's state, Mamba's conv window and SSM
        state and the encoder-decoder's cross K/V are replaced outright)."""
        for pool, one in zip(leaves(self.cache), leaves(cache1)):
            # the batch axis: the first where the pool has num_slots rows and
            # the batch-1 cache one (axis 1 when layers are stacked, as in
            # every encoder-decoder leaf, else 0); axis 0, the layers, has
            # as many in both, also when there are num_slots layers
            for ax in range(pool.ndim):
                if pool.shape[ax] == self.num_slots and one.shape[ax] == 1:
                    pool.narrow(ax, slot, 1).copy_(one)
                    break
            else:
                raise ValueError(f"no batch axis found: {tuple(pool.shape)} vs "
                                 f"{tuple(one.shape)}")

    def _admit(self) -> None:
        for slot in range(self.num_slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            P = len(req.prompt)
            if P >= self.max_len:
                raise ValueError(f"prompt length {P} >= max_len {self.max_len}")
            batch = {"tokens": torch.tensor(req.prompt[None], device=self.device)}
            if self.cfg.family == "encdec":  # the frontend stub: zero frames
                t_enc = self.cfg.encoder_seq_len or 1500
                fd = self.cfg.frontend_dim or self.cfg.d_model
                batch["frames"] = torch.zeros((1, t_enc, fd), dtype=torch.float32,
                                              device=self.device)
            cache1 = self._init_cache(1, self.max_len)
            logits, cache1 = self._prefill1(self.params, batch, cache1)
            tok = int(greedy_sample(logits)[0])
            self._scatter_cache(slot, cache1)
            req.t_first_token = time.monotonic()
            req.output.append(tok)
            self.active[slot] = req
            self.positions[slot] = P
            self.last_token[slot] = tok

    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        assert req is not None
        req.t_done = time.monotonic()
        self.completed.append(req)
        self.active[slot] = None

    @torch.inference_mode()
    def step(self) -> int:
        """One engine tick: admit -> batched decode -> sample -> retire.
        Returns number of tokens generated this tick."""
        self._admit()
        live = [s for s in range(self.num_slots) if self.active[s] is not None]
        if not live:
            return 0
        toks = torch.tensor(self.last_token[:, None], device=self.device)
        logits, self.cache = self._decode(self.params, self.cache, toks, self.positions)
        nxt = greedy_sample(logits).cpu().numpy()
        produced = 0
        for s in live:
            req = self.active[s]
            tok = int(nxt[s])
            req.output.append(tok)
            produced += 1
            self.positions[s] += 1
            self.last_token[s] = tok
            done = len(req.output) >= req.max_new_tokens or (
                req.eos_id is not None and tok == req.eos_id
            )
            if done or self.positions[s] + 1 >= self.max_len:
                self._retire(s)
        self.ticks += 1
        self.tokens_generated += produced
        return produced

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        while (self.queue or any(a is not None for a in self.active)) and self.ticks < max_ticks:
            self.step()
        return self.completed
