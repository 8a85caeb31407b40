"""Loader construction — the one documented entry point.

:func:`make_loader` is the front door the reference documents: give it a
:class:`~repro_torch.config.LoaderConfig` and a dataset, and it builds the
:class:`~repro_torch.core.loader.ConcurrentDataLoader` (legacy or staged
pipeline, per ``LoaderConfig.pipeline``; with its online autotuner, per
``LoaderConfig.autotune``).  The raw constructor keeps working.

A trimmed copy of the reference's factory: it takes a ``LoaderConfig``
only.  A ``RunConfig`` and the ``mesh`` parameter (sharded delivery) wait
for ROADMAP.md §1 item 7, and the serving mirror ``make_read_path`` waits
for ``serve/readpath.py`` (§1 item 5.7).
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.config import LoaderConfig
from repro_torch.core.loader import ConcurrentDataLoader
from repro_torch.core.tracing import NULL_TRACER, Tracer
from repro_torch.data.dataset import MapDataset, collate


def make_loader(
    cfg: Any,
    dataset: MapDataset,
    *,
    tracer: Tracer = NULL_TRACER,
    host_id: int = 0,
    num_hosts: int = 1,
    collate_fn: Callable = collate,
    worker_startup_cost_s: float = 0.0,
) -> ConcurrentDataLoader:
    """Build a :class:`ConcurrentDataLoader` from a :class:`LoaderConfig`.

    Raises ``TypeError`` for any other config (a ``RunConfig`` comes with
    sharded delivery, ROADMAP.md §1 item 7)."""
    if not isinstance(cfg, LoaderConfig):
        raise TypeError(
            f"make_loader expects a LoaderConfig, got {type(cfg).__name__}; "
            "RunConfig (with its mesh block) is not ported yet: "
            "ROADMAP.md §1 item 7 (sharded delivery)"
        )
    return ConcurrentDataLoader(
        dataset,
        cfg,
        host_id=host_id,
        num_hosts=num_hosts,
        collate_fn=collate_fn,
        tracer=tracer,
        worker_startup_cost_s=worker_startup_cost_s,
    )
