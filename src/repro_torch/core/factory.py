"""Loader construction — the one documented entry point.

:func:`make_loader` is the front door the reference documents: give it a
:class:`~repro_torch.config.RunConfig` or a
:class:`~repro_torch.config.LoaderConfig` and a dataset, and it builds the
:class:`~repro_torch.core.loader.ConcurrentDataLoader` (legacy or staged
pipeline, per ``LoaderConfig.pipeline``; with its online autotuner, per
``LoaderConfig.autotune``), resolving the mesh that
``DeliverySpec(kind='sharded')`` needs: an explicit ``mesh=``, the spec's
own, or one built from ``RunConfig.mesh``.  The raw constructor keeps
working.

:func:`make_read_path` is its serving mirror: give it a ``RunConfig`` (its
``serve`` block) or a :class:`~repro_torch.config.ServeSpec` and a store,
and it builds the multi-tenant :class:`~repro_torch.serve.readpath.ReadPath`.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Optional

from repro_torch.config import LoaderConfig, RunConfig, ServeSpec
from repro_torch.core.loader import ConcurrentDataLoader
from repro_torch.core.tracing import NULL_TRACER, Tracer
from repro_torch.data.dataset import MapDataset, collate


def make_loader(
    cfg: Any,
    dataset: MapDataset,
    *,
    mesh: Any = None,
    tracer: Tracer = NULL_TRACER,
    host_id: Optional[int] = None,
    num_hosts: Optional[int] = None,
    collate_fn: Callable = collate,
    worker_startup_cost_s: float = 0.0,
) -> ConcurrentDataLoader:
    """Build a :class:`ConcurrentDataLoader` from a run or loader config.

    * ``cfg``: a :class:`RunConfig` (its ``loader`` and ``mesh`` blocks are
      used) or a bare :class:`LoaderConfig`.
    * ``mesh``: an explicit :class:`repro_torch.launch.mesh.Mesh` for
      sharded delivery, overriding anything the config gives.  With a
      ``RunConfig`` and no mesh anywhere, one is built from
      ``RunConfig.mesh`` by :func:`repro_torch.launch.mesh.make_mesh` (over
      the process group's ranks when one is up, else the visible CUDA
      devices; only when the delivery spec asks for sharding, so host
      delivery never imports torch here).
    * ``host_id`` / ``num_hosts``: the slice of every global batch this
      process loads; by default the process group's rank and world size
      (host 0 of 1 without a group).

    Raises ``ValueError`` when sharded delivery is asked for and no mesh is
    resolvable, and ``TypeError`` for any other config."""
    if isinstance(cfg, RunConfig):
        lcfg = cfg.loader
        if lcfg.delivery.kind == "sharded" and lcfg.delivery.mesh is None and mesh is None:
            from repro_torch.launch.mesh import make_mesh

            mesh = make_mesh(cfg.mesh.shape, cfg.mesh.axes)
    elif isinstance(cfg, LoaderConfig):
        lcfg = cfg
    else:
        raise TypeError(
            f"make_loader expects a RunConfig or LoaderConfig, got {type(cfg).__name__}"
        )
    if lcfg.delivery.kind == "sharded" and lcfg.delivery.mesh is None:
        if mesh is None:
            raise ValueError(
                "DeliverySpec(kind='sharded') has no mesh: pass mesh=... to make_loader, "
                "use DeliverySpec.sharded(mesh, ...), or construct from a RunConfig "
                "whose mesh block describes one"
            )
        lcfg = replace(lcfg, delivery=replace(lcfg.delivery, mesh=mesh))
    return ConcurrentDataLoader(
        dataset,
        lcfg,
        host_id=host_id,
        num_hosts=num_hosts,
        collate_fn=collate_fn,
        tracer=tracer,
        worker_startup_cost_s=worker_startup_cost_s,
    )


def make_read_path(
    cfg: Any,
    store: Any,
    *,
    tracer: Tracer = NULL_TRACER,
) -> Any:
    """Build a :class:`repro_torch.serve.readpath.ReadPath` from a run or
    serve config: the serving mirror of :func:`make_loader`.

    * ``cfg``: a :class:`RunConfig` (its ``serve`` block is used) or a bare
      :class:`ServeSpec`; raises ``TypeError`` for any other.
    * ``store``: any ``ObjectStore``-shaped store; a
      :class:`repro_torch.data.cache.TieredCacheStore` also gets cache-only
      hit serving and (with autotune enabled) its cache knobs tuned against
      the latency target.

    The import is lazy: ``repro_torch.serve`` imports the engine, and with
    it torch, which ``repro_torch.core`` does not import."""
    if isinstance(cfg, RunConfig):
        spec = cfg.serve
    elif isinstance(cfg, ServeSpec):
        spec = cfg
    else:
        raise TypeError(
            f"make_read_path expects a RunConfig or ServeSpec, got {type(cfg).__name__}"
        )
    from repro_torch.serve.readpath import ReadPath  # lazy: keep core torch-free

    return ReadPath(store, spec, tracer=tracer)
