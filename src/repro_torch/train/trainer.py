"""Trainer with hooks/callbacks — the "Lightning analogue" (paper §A.3).

A raw loop (:func:`raw_train_loop`, the "Torch" path) vs :class:`Trainer`
(hooks before/after every batch, logging callbacks with configurable
frequency/cost).  Both share the train step, the ConcurrentDataLoader and the
device prefetch ring, and record the paper's span lanes so Table-3 style
stats come out of the same tracer.  Metrics are read with ``.item()``, which
waits for the step's device work, so each ``run_training_batch`` span covers
it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from repro_torch.core.prefetch import DevicePrefetchRing
from repro_torch.core.tracing import NULL_TRACER, RUN_TRAINING_BATCH, Tracer
from repro_torch.core.utilization import recent_busy_fraction
from repro_torch.device import resolve_device


class Callback:
    def on_train_start(self, trainer: "Trainer") -> None: ...
    def on_epoch_start(self, trainer: "Trainer", epoch: int) -> None: ...
    def on_train_batch_start(self, trainer: "Trainer", batch: Any, idx: int) -> None: ...
    def on_train_batch_end(self, trainer: "Trainer", metrics: Dict, idx: int) -> None: ...
    def on_epoch_end(self, trainer: "Trainer", epoch: int) -> None: ...
    def on_train_end(self, trainer: "Trainer") -> None: ...


class LoggingCallback(Callback):
    """Emulates the paper's GPUStatsMonitor-style logger: every call burns
    ``cost_s`` of host time (the 'slightly too aggressive logging')."""

    def __init__(self, log_every_n_steps: int = 10, cost_s: float = 0.0,
                 sink: Optional[Callable[[str], None]] = None) -> None:
        self.every = max(log_every_n_steps, 1)
        self.cost_s = cost_s
        self.sink = sink or (lambda s: None)
        self.lines: List[str] = []

    def on_train_batch_end(self, trainer, metrics, idx) -> None:
        if idx % self.every == 0:
            if self.cost_s:
                time.sleep(self.cost_s)
            line = f"step={trainer.global_step} " + " ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items()
            )
            self.lines.append(line)
            self.sink(line)


@dataclass
class TrainResult:
    steps: int
    epochs: int
    wall_s: float
    last_metrics: Dict[str, float] = field(default_factory=dict)
    history: List[Dict[str, float]] = field(default_factory=list)


def _read_metrics(m: Dict[str, Any]) -> Dict[str, float]:
    return {k: v.item() if isinstance(v, torch.Tensor) else float(v) for k, v in m.items()}


def _make_ring(loader, depth: int, tracer: Tracer, ingest_fn, device) -> DevicePrefetchRing:
    """The per-epoch device prefetch ring over ``iter(loader)``.  When the
    loader carries an autotuner, the ring's depth becomes a live knob (with
    headroom up to the configured bound), and a real tracer's busy fraction
    becomes its utilization signal, so the controller stops buying loader
    throughput the step can't eat (``AutotuneConfig.util_gate``).  The ring
    is the staged pipeline's final stage: a loader that can
    (``note_device_ring``) remembers it, which folds its depth into
    ``loader.stage_stats()``."""
    auto = getattr(loader, "autotuner", None)
    max_depth = depth
    if auto is not None:
        max_depth = max(depth, auto.cfg.max_device_prefetch)
    ring = DevicePrefetchRing(iter(loader), depth=depth, max_depth=max_depth,
                              tracer=tracer, ingest_fn=ingest_fn, device=device)
    if auto is not None:
        # iter(loader) above re-bound the loader knobs; the ring knob rides
        # along for this epoch and is dropped at the next re-bind
        auto.attach_ring(ring)
        if tracer is not NULL_TRACER and auto.util_fn is None:
            auto.util_fn = lambda: recent_busy_fraction(tracer)
    note = getattr(loader, "note_device_ring", None)
    if callable(note):
        note(ring)
    return ring


def _release_coordination(loader) -> None:
    """End-of-run courtesy for multi-host runs: hand back any held up-probe
    lease and elastic membership slot, so co-located hosts do not wait out
    the crash TTL."""
    release = getattr(loader, "release_coordination", None)
    if callable(release):
        release()


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        state: Any,
        *,
        callbacks: Optional[List[Callback]] = None,
        tracer: Tracer = NULL_TRACER,
        device_prefetch: int = 2,
        ingest_fn: Optional[Callable] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.train_step = train_step
        self.state = state
        self.callbacks = callbacks or []
        self.tracer = tracer
        self.device_prefetch = device_prefetch
        # dict -> dict device-side batch epilogue (see
        # repro_torch.kernels.ingest_norm.ops.make_ingest_fn); None = host epilogue
        self.ingest_fn = ingest_fn
        self.global_step = 0

    def _hook(self, name: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, name)(self, *args)

    def fit(
        self,
        loader: Iterable,
        epochs: int = 1,
        max_steps: Optional[int] = None,
        start_epoch: int = 0,
    ) -> TrainResult:
        t0 = time.time()
        self._hook("on_train_start")
        history: List[Dict[str, float]] = []
        metrics: Dict[str, float] = {}
        done = False
        for epoch in range(start_epoch, epochs):
            if hasattr(loader, "set_epoch") and epoch != start_epoch:
                loader.set_epoch(epoch)
            self._hook("on_epoch_start", epoch)
            ring = _make_ring(loader, self.device_prefetch, self.tracer,
                              self.ingest_fn, self.device)
            try:
                for i, batch in enumerate(ring):
                    self._hook("on_train_batch_start", batch, i)
                    with self.tracer.span(RUN_TRAINING_BATCH, step=self.global_step):
                        self.state, m = self.train_step(self.state, batch)
                        m = _read_metrics(m)
                    self.global_step += 1
                    metrics = m
                    history.append(m)
                    self._hook("on_train_batch_end", m, i)
                    if max_steps is not None and self.global_step >= max_steps:
                        done = True
                        break
            finally:
                ring.close()
            self._hook("on_epoch_end", epoch)
            if done:
                break
        self._hook("on_train_end")
        _release_coordination(loader)
        return TrainResult(
            steps=self.global_step,
            epochs=epoch + 1,
            wall_s=time.time() - t0,
            last_metrics=metrics,
            history=history,
        )


def raw_train_loop(
    train_step: Callable,
    state: Any,
    loader: Iterable,
    *,
    epochs: int = 1,
    max_steps: Optional[int] = None,
    tracer: Tracer = NULL_TRACER,
    device_prefetch: int = 2,
    ingest_fn: Optional[Callable] = None,
    device: Union[str, torch.device] = "cuda",
) -> TrainResult:
    """The 'pure Torch' path: no hooks, no callbacks, same train step."""
    dev = resolve_device(device)
    t0 = time.time()
    steps = 0
    metrics: Dict[str, float] = {}
    history = []
    for epoch in range(epochs):
        if hasattr(loader, "set_epoch") and epoch:
            loader.set_epoch(epoch)
        ring = _make_ring(loader, device_prefetch, tracer, ingest_fn, dev)
        try:
            for batch in ring:
                with tracer.span(RUN_TRAINING_BATCH, step=steps):
                    state, m = train_step(state, batch)
                    metrics = _read_metrics(m)
                history.append(metrics)
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    break
        finally:
            ring.close()
        if max_steps is not None and steps >= max_steps:
            _release_coordination(loader)
            return TrainResult(steps, epoch + 1, time.time() - t0, metrics, history)
    _release_coordination(loader)
    return TrainResult(steps, epochs, time.time() - t0, metrics, history)
