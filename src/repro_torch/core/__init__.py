"""Core: the paper's concurrent data-loading contribution (loader, fetchers,
workers, sampler, the staged pipeline and pinned staging), the online
autotuner, the device prefetch ring, tracing and utilization.

:func:`make_loader` is the documented construction surface
(:func:`make_read_path` its serving mirror);
:class:`ConcurrentDataLoader` stays available for callers that want the raw
constructor.  These names resolve on first access (PEP 562), so that
importing a leaf module such as :mod:`repro_torch.core.tracing` (which
:mod:`repro_torch.data.dataset` does) never pulls in the loader, which
itself imports the dataset module.  Nothing here imports ``torch`` (the
device prefetch ring, :mod:`repro_torch.core.prefetch`, and the engine
beside the read path do).
"""
from __future__ import annotations

from typing import Any

__all__ = [
    "AutotuneController",
    "ConcurrentDataLoader",
    "Knob",
    "LoaderTimeout",
    "TuneEvent",
    "make_loader",
    "make_read_path",
]


def __getattr__(name: str) -> Any:
    if name in ("make_loader", "make_read_path"):
        from repro_torch.core import factory

        return getattr(factory, name)
    if name in ("AutotuneController", "Knob", "TuneEvent"):
        from repro_torch.core import autotune

        return getattr(autotune, name)
    if name in ("ConcurrentDataLoader", "LoaderTimeout"):
        from repro_torch.core import loader

        return getattr(loader, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
