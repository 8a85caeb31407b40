"""Core: the paper's concurrent data-loading contribution (loader, fetchers,
workers, sampler, the staged pipeline and pinned staging), the online
autotuner, the device prefetch ring, tracing and utilization.

:func:`make_loader` is the documented construction surface;
:class:`ConcurrentDataLoader` stays available for callers that want the raw
constructor.  The three names resolve on first access (PEP 562), so that
importing a leaf module such as :mod:`repro_torch.core.tracing` (which
:mod:`repro_torch.data.dataset` does) never pulls in the loader, which
itself imports the dataset module.  Nothing here imports ``torch`` (the
device prefetch ring, :mod:`repro_torch.core.prefetch`, does).
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
]


def __getattr__(name: str) -> Any:
    if name == "make_loader":
        from repro_torch.core.factory import make_loader

        return make_loader
    if name in ("AutotuneController", "Knob", "TuneEvent"):
        from repro_torch.core import autotune

        return getattr(autotune, name)
    if name in ("ConcurrentDataLoader", "LoaderTimeout"):
        from repro_torch.core import loader

        return getattr(loader, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
