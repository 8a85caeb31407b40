"""ConcurrentDataLoader — drop-in loader with the paper's modifications.

Three implementations selected by ``LoaderConfig.impl``:

* ``vanilla``  — batch-level parallelism only (stock PyTorch semantics:
  ``num_workers`` workers, items of a batch fetched sequentially, blocking
  worker start-up in the constructor).
* ``threaded`` — + within-batch parallelism via a per-worker thread pool
  (``num_fetch_workers``), optional batch disassembly (``batch_pool``),
  optional hedged requests.
* ``asyncio``  — + within-batch concurrency via a per-worker event loop.

Lazy, non-blocking initialization (paper Fig. 8) is controlled by
``lazy_init``: workers are started on the first ``__next__``, with index
dispatch beginning as soon as each worker exists.

Delivery is *in batch order* (a reorder buffer holds early arrivals), so all
implementations yield bit-identical streams for a fixed seed.

``LoaderConfig.pipeline`` (enabled) swaps the legacy worker iterator for the
staged pipeline (:mod:`repro_torch.core.pipeline`), with optional pinned
host staging (:mod:`repro_torch.core.staging`).  ``LoaderConfig.autotune``
(enabled) gives the loader an :class:`~repro_torch.core.autotune.
AutotuneController` that moves either iterator's knobs between batches;
its learned values persist across epochs on the loader.  A store stack
holding a :class:`~repro_torch.data.cache.TieredCacheStore` gives the
autotuner its cache knobs, on the per-batch controller or, with
``cache_cadence="epoch"``, on a second controller fed once per epoch.
``AutotuneConfig.coord_dir`` puts upward probes under a fleet-wide lease
(and, with ``shed_collapse_fraction``, collapses under fleet-wide
shedding); ``LoaderConfig.elastic`` replaces static sharding with claims
on an :class:`~repro_torch.core.elastic.ElasticBatchSampler` (legacy path
only).  :meth:`ConcurrentDataLoader.release_coordination` hands back the
lease and the membership slot.  ``LoaderConfig.sampler`` (a
:class:`~repro_torch.config.SamplerPredicate`) filters each epoch's stream
through the dataset's ``predicate_mask`` (columnar pushdown), on the static
and the elastic sampler alike.  ``LoaderConfig.delivery`` sharded (staged
pipeline, strict reorder) builds a :class:`~repro_torch.core.delivery.
LanePlan` here (:attr:`ConcurrentDataLoader.delivery_plan`): its lanes
collate and copy each batch's rows to the card, so the loader yields device
batches (:attr:`~ConcurrentDataLoader.delivers_device_batches`), its
``state_dict`` carries a lane-cursor block, and with
``AutotuneConfig.skew_gate`` the controller stops probing upward while the
lanes diverge.  Under a process group (one process a card) each rank loads,
and composes, only its contiguous slice of every global batch
(:func:`~repro_torch.core.sampler.shard_plan`): ``host_id`` and
``num_hosts`` default to the group's rank and world size.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import weakref
from dataclasses import replace
from typing import Any, Callable, Dict, Iterator, List, Optional

from repro_torch.config import LoaderConfig
from repro_torch.core.autotune import (
    AutotuneController,
    Knob,
    build_cache_knobs,
    build_loader_knobs,
    make_weak_knob_callbacks,
)
from repro_torch.core.elastic import ClaimStarved, ElasticBatchSampler, ElasticSession
from repro_torch.core.fetcher import HedgeTracker, make_fetcher
from repro_torch.core.sampler import BatchIndices, ShardedBatchSampler
from repro_torch.core.tracing import GET_BATCH, NULL_TRACER, Tracer
from repro_torch.core.worker import Worker, WorkerFailure, _SENTINEL
from repro_torch.data.dataset import MapDataset, collate


class LoaderTimeout(RuntimeError):
    pass


def _store_stats_fn(dataset: MapDataset):
    """Find a ``stats`` provider in the dataset's store stack (e.g.
    SimulatedS3Store): a live signal for the autotuner's diagnostics."""
    store = getattr(dataset, "store", None)
    while store is not None:
        if hasattr(store, "stats"):
            return lambda s=store: s.stats
        store = getattr(store, "base", None)
    return None


def _find_tiered_cache(dataset: MapDataset):
    """Find a TieredCacheStore in the dataset's store stack (duck-typed on
    its knob surface) so its capacities and admission become autotune
    knobs."""
    store = getattr(dataset, "store", None)
    while store is not None:
        if hasattr(store, "set_memory_capacity"):
            return store
        store = getattr(store, "base", None)
    return None


class ConcurrentDataLoader:
    def __init__(
        self,
        dataset: MapDataset,
        cfg: LoaderConfig,
        *,
        host_id: Optional[int] = None,
        num_hosts: Optional[int] = None,
        collate_fn: Callable = collate,
        tracer: Tracer = NULL_TRACER,
        worker_startup_cost_s: float = 0.0,
    ) -> None:
        if host_id is None and num_hosts is None:
            # one process a card: under a process group this rank loads its
            # contiguous slice of every global batch (host r of W); one host
            # without a group
            from repro_torch.launch import dist

            host_id, num_hosts = dist.rank(), dist.world_size()
        host_id = 0 if host_id is None else host_id
        num_hosts = 1 if num_hosts is None else num_hosts
        pipe = cfg.pipeline
        if cfg.impl not in ("vanilla", "threaded", "asyncio"):
            raise ValueError(f"unknown loader impl {cfg.impl!r}")
        if pipe.reorder not in ("strict", "window"):
            raise ValueError(
                f"unknown reorder {pipe.reorder!r}; known: 'strict', 'window'"
            )
        if pipe.cpu_executor not in ("thread", "process"):
            raise ValueError(
                f"unknown cpu_executor {pipe.cpu_executor!r}; "
                "known: 'thread', 'process'"
            )
        if pipe.transport not in ("pipe", "shm"):
            raise ValueError(
                f"unknown transport {pipe.transport!r}; known: 'pipe', 'shm'"
            )
        if pipe:
            # fail at construction, naming the field — not at first iter()
            if cfg.impl == "vanilla":
                raise ValueError(
                    "pipeline requires impl 'threaded' or 'asyncio' "
                    "(vanilla's sequential fetch has no staged equivalent)"
                )
            if pipe.reorder_window < 1:
                raise ValueError("reorder_window must be >= 1")
            for field in ("io_workers", "cpu_workers"):
                if getattr(pipe, field) < 0:
                    raise ValueError(f"{field} must be >= 0 (0 = derive)")
            if pipe.stage_queue_depth < 1:
                raise ValueError("stage_queue_depth must be >= 1")
            if pipe.transport == "shm":
                if pipe.slab_slot_bytes < 1 or pipe.slab_slots < 1:
                    raise ValueError(
                        "transport='shm' needs slab_slot_bytes >= 1 and "
                        "slab_slots >= 1 (one slot must hold one decoded "
                        "sample)"
                    )
            if pipe.staging_buffers < 0:
                raise ValueError("staging_buffers must be >= 0 (0 = off)")
            at_ = cfg.autotune
            if at_.enabled and at_.thread_budget:
                floor = at_.min_fetch_workers + max(at_.min_cpu_workers, 1)
                if at_.thread_budget < floor:
                    raise ValueError(
                        f"thread_budget={at_.thread_budget} cannot cover "
                        f"min_fetch_workers + min_cpu_workers (= {floor}): "
                        "the io/cpu split needs at least one thread per stage"
                    )
        spec = cfg.delivery
        if spec.kind not in ("host", "sharded"):
            raise ValueError(
                f"unknown delivery kind {spec.kind!r}; known: 'host', 'sharded'"
            )
        self.delivery_plan = None
        self._cursor_board = None
        if spec.kind == "sharded":
            if not pipe:
                raise ValueError(
                    "delivery='sharded' requires the staged pipeline "
                    "(pipeline=PipelineConfig(enabled=True)): lane assembly "
                    "consumes the pipeline's per-sample completion stream"
                )
            if pipe.reorder != "strict":
                raise ValueError(
                    "delivery='sharded' requires reorder='strict': per-lane "
                    "cursors are only fleet-alignable when every host "
                    "delivers in batch-id order"
                )
            from repro_torch.core.delivery import LanePlan, ShardCursorBoard

            if cfg.batch_size % max(num_hosts, 1):
                raise ValueError(
                    f"global batch of {cfg.batch_size} rows does not split over "
                    f"{num_hosts} hosts")
            plan = LanePlan.build(spec, cfg.batch_size // max(num_hosts, 1))
            self.delivery_plan = plan
            # the lanes write one tensor on one device a process: refuse any
            # other plan here, not at the first iter()
            plan.compose_device()
            if spec.coord_dir:
                self._cursor_board = ShardCursorBoard(spec.coord_dir, num_hosts=num_hosts)
        self.dataset = dataset
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.collate_fn = collate_fn
        self.tracer = tracer
        self.worker_startup_cost_s = worker_startup_cost_s
        self.sampler = ShardedBatchSampler(
            len(dataset),
            cfg.batch_size,
            shuffle=cfg.shuffle,
            seed=cfg.seed,
            drop_last=cfg.drop_last,
            host_id=host_id,
            num_hosts=num_hosts,
        )
        if cfg.sampler:
            # predicate pushdown: the sampler filters each epoch's stream by
            # dataset metadata, so rejected rows' bytes are never requested.
            # The mask is a pure function of (predicate, epoch): strict-mode
            # resume cursors replay the identical filtered stream.
            if not hasattr(dataset, "predicate_mask"):
                raise ValueError(
                    "LoaderConfig.sampler (predicate pushdown) requires a "
                    "dataset exposing predicate metadata via "
                    "predicate_mask(clauses), e.g. "
                    "repro_torch.data.columnar.ColumnarImageDataset; "
                    f"{type(dataset).__name__} does not"
                )
            pred = cfg.sampler

            def _predicate_filter(epoch: int):
                clauses = pred.clauses_for_epoch(epoch)
                if not clauses:
                    return None  # an unfiltered epoch (curriculum warm-up)
                return dataset.predicate_mask(clauses)

            self.sampler.set_filter(_predicate_filter)
        # elastic fleet mode (repro_torch.core.elastic): claim-based batch
        # scheduling over the coord substrate replaces static sharding, so
        # hosts may join, leave or crash mid-epoch and the fleet-wide union
        # of delivered batches still covers the epoch exactly
        self._elastic: Optional[ElasticSession] = None
        if cfg.elastic:
            if not cfg.elastic.coord_dir:
                raise ValueError("elastic mode requires ElasticConfig.coord_dir")
            if num_hosts != 1:
                raise ValueError(
                    "elastic mode replaces static host_id/num_hosts sharding "
                    "with claim-based scheduling of whole global batches; "
                    "construct each elastic host with num_hosts=1"
                )
            if pipe:
                raise ValueError(
                    "elastic mode currently requires the legacy loader path "
                    "(pipeline=PipelineConfig(enabled=False)): the staged "
                    "pipeline's dispatcher does not yet retry a "
                    "claim-starved sampler"
                )
            if spec.kind == "sharded":
                raise ValueError(
                    "elastic mode is incompatible with delivery='sharded': "
                    "lane cursors assume a static host->shard mapping"
                )
            self._elastic = ElasticSession(
                cfg.elastic, member=f"host{host_id}-pid{os.getpid()}"
            )
            elastic_sampler = ElasticBatchSampler(
                len(dataset),
                cfg.batch_size,
                shuffle=cfg.shuffle,
                seed=cfg.seed,
                drop_last=cfg.drop_last,
                session=self._elastic,
            )
            if cfg.sampler:
                elastic_sampler.set_filter(self.sampler._filter_fn)
            self.sampler = elastic_sampler
        # hedging pairs with any path whose assembler runs a hedge scan: the
        # legacy threaded iterator and both staged-pipeline IO modes
        self.hedge = (
            HedgeTracker(cfg.hedge_factor, cfg.hedge_min_s)
            if cfg.hedge_requests and (cfg.impl == "threaded" or pipe)
            else None
        )
        self._epoch = 0
        self._consumed = 0  # batches actually yielded to the caller this epoch
        # online knob control: the controller and the tuned values live on
        # the LOADER so learning persists across epochs; each epoch's
        # iterator re-binds the knob callbacks to itself
        at = cfg.autotune
        probe_lease = None
        congestion = None
        if at.enabled and at.coord_dir:
            # multi-host cooperation: upward probes need the fleet-wide
            # token under the shared coord dir.  With elastic membership, a
            # holder that left the fleet is reaped at once instead of idling
            # the token out to its TTL.
            from repro_torch.core.coord import CongestionBoard, UpProbeLease

            probe_lease = UpProbeLease(
                at.coord_dir,
                owner=f"host{host_id}-pid{os.getpid()}",
                ttl_s=at.coord_ttl_s,
                membership=(
                    self._elastic.membership if self._elastic is not None else None
                ),
            )
            if at.shed_collapse_fraction > 0:
                # cooperative AIMD down-shedding: collapse events post to
                # the fleet board and every controller cuts multiplicatively
                congestion = CongestionBoard(
                    at.coord_dir, host=f"host{host_id}-pid{os.getpid()}"
                )
        skew_fn = None
        if at.enabled and at.skew_gate > 0 and spec.kind == "sharded":
            # lane-skew gate: the delivery stage's composed-batch divergence,
            # so the controller stops probing upward while the lanes are
            # imbalanced.  Weakref: the controller is owned BY the loader.
            _self_ref = weakref.ref(self)

            def skew_fn() -> Optional[float]:
                loader = _self_ref()
                if loader is None:
                    return None
                delivery = (loader.stage_stats() or {}).get("delivery")
                return delivery.get("lane_skew") if delivery else None

        entropy_fn = None
        if (
            at.enabled
            and at.min_shuffle_entropy > 0.0
            and pipe
            and pipe.reorder == "window"
        ):
            # shuffle-entropy floor: feed the controller the delivered
            # stream's within-batch entropy.  Weakref: the controller is
            # owned BY the loader, and a strong cycle would defer
            # __del__-driven worker shutdown to the gc.
            _ent_ref = weakref.ref(self)

            def entropy_fn() -> Optional[float]:
                loader = _ent_ref()
                if loader is None:
                    return None
                shuffle = (loader.stage_stats() or {}).get("shuffle")
                return shuffle.get("within_batch") if shuffle else None

        self.autotuner: Optional[AutotuneController] = (
            AutotuneController(
                at,
                [],
                tracer=tracer,
                store_stats_fn=_store_stats_fn(dataset),
                probe_lease=probe_lease,
                skew_fn=skew_fn,
                entropy_fn=entropy_fn,
                congestion=congestion,
            )
            if at.enabled
            else None
        )
        self._tuned: Dict[str, int] = {}
        # spawn-process CPU pool (pipeline cpu_executor="process"): owned by
        # the loader because workers cost hundreds of ms to spawn; each
        # epoch's pipeline iterator attaches and rebinds.  close() ends it.
        self._cpu_pool = None
        # cache-tier knobs: the cache outlives every iterator, so the knob
        # list is built once here and re-attached after each epoch's bind().
        # The cache's tracer is not rebound here: the store may be shared by
        # several loaders (pass a tracer to build_store for cache_get spans).
        self._cache_knobs: List[Knob] = []
        # epoch-cadence cache tuning: capacity knobs pay off one epoch later
        # in full-pass regimes, so with cache_cadence="epoch" the cache knobs
        # get their own controller, judged on cache_epoch_windows-epoch
        # windows fed from _note_epoch_end, instead of riding the per-batch
        # controller
        self.cache_autotuner: Optional[AutotuneController] = None
        if at.enabled and at.cache_cadence not in ("batch", "epoch"):
            # a typo'd cadence must not silently fall back to per-batch
            raise ValueError(
                f"unknown cache_cadence {at.cache_cadence!r}; "
                "known: 'batch', 'epoch'"
            )
        if self.autotuner is not None and at.tune_cache:
            cache = _find_tiered_cache(dataset)
            if cache is not None:
                knobs = build_cache_knobs(at, cache)
                if knobs and at.cache_cadence == "epoch":
                    epoch_cfg = replace(
                        at,
                        interval_batches=max(at.cache_epoch_windows, 1),
                        min_window_s=0.0,
                        warmup_windows=1,
                        # epoch-scale windows on a shared machine: a slow
                        # phase spanning one window says nothing about the
                        # knobs, so never restore-on-collapse here
                        collapse_restore=False,
                    )
                    self.cache_autotuner = AutotuneController(epoch_cfg, knobs)
                else:
                    self._cache_knobs = knobs

    # -- epoch / resume ------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._consumed = 0
        self.sampler.set_epoch(epoch)
        self.dataset.set_epoch(epoch)

    @property
    def delivers_device_batches(self) -> bool:
        """True when batches arrive already on the device (sharded
        delivery): the device prefetch ring must not copy them again."""
        return self.delivery_plan is not None

    def state_dict(self) -> Dict[str, Any]:
        """Consumer position: (epoch, batches yielded).  Prefetched-but-
        unconsumed batches are NOT counted — a restart replays them.
        Sharded delivery adds the lane-cursor block (:meth:`cursor_state`)."""
        return self.cursor_state(self._epoch, self._consumed)

    def cursor_state(self, epoch: int, next_batch: int) -> Dict[str, Any]:
        """The state of a consumer at ``(epoch, next_batch)``: the trainer's
        checkpoint callback passes its own step, since the device prefetch
        ring consumes batches ahead of the training step.

        Sharded delivery adds a per-lane cursor block.  Strict composition
        delivers lanes in lockstep (a batch exists only once every lane
        wrote its rows), so each lane's cursor equals the consumer's;
        recording them lets a restart check the mesh slicing still matches,
        and is what the fleet board publishes per host.  With a board the
        cursor is pinned to the fleet minimum.  Under a process group whose
        ranks span the plan (one process a card) the block holds every
        rank's lane, gathered in rank order: the block the reference's one
        process writes for the same mesh.  That gather is a collective, so
        every rank calls this at the same step."""
        state: Dict[str, Any] = {"epoch": int(epoch), "next_batch": int(next_batch)}
        plan = self.delivery_plan
        if plan is not None:
            if self._cursor_board is not None:
                self._cursor_board.publish(self.host_id, epoch, next_batch)
                aligned = self._cursor_board.aligned()
                if aligned is not None and aligned < (epoch, next_batch):
                    # resume from the newest batch boundary EVERY host has
                    # delivered, so the restored global batch is consistent
                    # fleet-wide without a gather
                    epoch, next_batch = aligned
                    state["epoch"], state["next_batch"] = int(epoch), int(next_batch)
            from repro_torch.core.delivery import device_id

            base = plan.process_index * plan.num_lanes
            lanes = [{"lane": base + i, "next_batch": int(next_batch),
                      "devices": [device_id(d) for d in devs]}
                     for i, devs in enumerate(plan.lanes)]
            if plan.global_mult > 1:
                # one process a card: every rank's lanes, in rank order, are
                # the block the reference's one process writes for the mesh
                # (a collective: every rank calls this at the same step)
                from repro_torch.launch import dist

                lanes = [ln for part in dist.all_gather_object(lanes) for ln in part]
            state["delivery"] = {
                "kind": "sharded",
                "axis": plan.axis,
                "num_lanes": len(lanes),
                "lanes": lanes,
            }
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._epoch = int(state["epoch"])
        self._consumed = int(state["next_batch"])
        delivery = state.get("delivery")
        if delivery is not None:
            plan = self.delivery_plan
            if plan is None:
                raise ValueError(
                    "checkpoint carries sharded-delivery lane cursors but this "
                    "loader delivers host batches; restore with "
                    "delivery=DeliverySpec.sharded(...)"
                )
            total = plan.num_lanes * plan.global_mult
            if int(delivery["num_lanes"]) != total:
                raise ValueError(
                    f"checkpoint has {delivery['num_lanes']} delivery lanes but the "
                    f"current mesh slices into {total}; lane cursors are only "
                    "portable across identical data-axis slicings"
                )
            lanes = delivery.get("lanes", [])
            if lanes:
                # lanes are delivered in lockstep, but a checkpoint cut by a
                # crashing writer may carry a torn cursor set: resume from
                # the minimum so no lane skips data
                self._consumed = min(self._consumed,
                                     min(int(ln["next_batch"]) for ln in lanes))
        self.dataset.set_epoch(self._epoch)
        self.sampler.load_state_dict(
            {"epoch": self._epoch, "next_batch": self._consumed}
        )

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self):
        if self.cfg.pipeline:
            # staged streaming path: stage graph with dedicated IO/CPU
            # executors + out-of-order sample completion
            from repro_torch.core.pipeline import _PipelineIter

            it = _PipelineIter(self)
        else:
            it = _LoaderIter(self)
        # weakref: observability must not pin an abandoned iterator (and its
        # worker/stage threads) past the consumer dropping it
        self._active_iter = weakref.ref(it)
        return it

    def stage_stats(self) -> Optional[Dict[str, Any]]:
        """Per-stage snapshot of the most recent pipeline iterator (queue
        occupancy, executor widths, staging, hedges), plus the device
        prefetch ring's depth when a trainer attached one.  None outside
        pipeline mode."""
        ref = getattr(self, "_active_iter", None)
        it = ref() if ref is not None else None
        stats_fn = getattr(it, "stage_stats", None)
        if stats_fn is None:
            # iterator already collected (or legacy mode): the final
            # snapshot the pipeline iterator left at shutdown
            out = getattr(self, "_last_stage_stats", None)
            if out is None:
                return None
            out = dict(out)
        else:
            out = stats_fn()
        ring_ref = getattr(self, "_device_ring", None)
        ring = ring_ref() if ring_ref is not None else None
        if ring is not None:
            out["device_prefetch_depth"] = ring.depth
        return out

    def note_device_ring(self, ring: Any) -> None:
        """Trainer hook: the device prefetch ring is the pipeline's final
        stage; remembering it (weakly) folds its depth into stage_stats."""
        self._device_ring = weakref.ref(ring)

    def _note_batch_delivered(self) -> None:
        """One batch crossed into the consumer: elastic mode forwards the
        event to the claim sampler's confirmation pipeline."""
        note = getattr(self.sampler, "note_delivered", None)
        if note is not None:
            note()

    def _note_epoch_end(self) -> None:
        """The epoch drained: confirm every delivered batch to an elastic
        fleet, and feed the epoch-cadence cache controller one completed
        epoch (items = batches consumed; only the rate's consistency
        matters)."""
        flush = getattr(self.sampler, "flush_delivered", None)
        if flush is not None:
            flush()
        if self.cache_autotuner is not None and self._consumed:
            self.cache_autotuner.on_batch(items=self._consumed)

    def release_coordination(self) -> None:
        """Hand back any held up-probe lease and the elastic membership slot
        (clean shutdown: peers should not have to wait out the crash TTL).
        Safe to call repeatedly."""
        for ctrl in (self.autotuner, self.cache_autotuner):
            if ctrl is not None:
                ctrl.release_coordination()
        if self._elastic is not None:
            self._elastic.leave()

    def close(self) -> None:
        """End the process CPU pool's workers, if a pipeline epoch started
        them, and release the loader's coordination.  The loader stays
        usable: a later epoch spawns a new pool (and an elastic loader
        rejoins its fleet)."""
        pool, self._cpu_pool = self._cpu_pool, None
        if pool is not None:
            pool.close()
        self.release_coordination()


def deliver_traced(it) -> Any:
    """Shared ``__next__`` body of ``_LoaderIter`` and the pipeline's
    iterator: one ``get_batch`` span per delivered batch (tagged with the
    batch's byte count) and the autotuner's ``on_batch`` at the safe
    between-batch boundary (knob moves only affect how FUTURE work is
    dispatched, never delivery order).  The end-of-epoch drain (sampler
    exhausted, window shrinking) is excluded: its throughput says nothing
    about the knobs."""
    t0 = time.monotonic()
    batch = it._next_impl()  # StopIteration passes through untraced
    args = {}
    if isinstance(batch, dict) and "nbytes" in batch:
        args["nbytes"] = int(batch["nbytes"].sum())
    it.tracer.record(GET_BATCH, t0, time.monotonic(), **args)
    it.loader._note_batch_delivered()
    auto = it.loader.autotuner
    if auto is not None and not it._exhausted:
        auto.on_batch()
    return batch


class _LoaderIter:
    def __init__(self, loader: ConcurrentDataLoader) -> None:
        self.loader = loader
        cfg = loader.cfg
        self.cfg = cfg
        self.tracer = loader.tracer
        at = cfg.autotune
        self.max_outstanding = max(1, cfg.num_workers * cfg.prefetch_factor)
        self._fetch_workers = cfg.num_fetch_workers
        self._fetch_hard_cap: Optional[int] = None
        # effective knob ceilings, widened to cover the explicit static
        # config: turning the tuner ON must never cap the loader below its
        # autotune=off operating point
        self._max_outstanding_bound = max(at.max_outstanding, self.max_outstanding)
        self._max_fetch_bound = max(at.max_fetch_workers, cfg.num_fetch_workers)
        if at.enabled:
            # resume from values the controller already learned (prev epoch)
            self.max_outstanding = min(
                max(loader._tuned.get("outstanding", self.max_outstanding),
                    at.min_outstanding),
                self._max_outstanding_bound,
            )
            self._fetch_workers = min(
                max(loader._tuned.get("fetch_workers", self._fetch_workers),
                    at.min_fetch_workers),
                self._max_fetch_bound,
            )
            self._fetch_hard_cap = self._max_fetch_bound
        # queue backpressure: sized for the knob's upper bound when autotuned
        # (the live window is enforced by _dispatch), exactly max_outstanding
        # otherwise, as the static loader
        qsize = self._max_outstanding_bound if at.enabled else self.max_outstanding
        self.data_queue: "queue.Queue" = queue.Queue(maxsize=qsize)
        self.index_queues: List["queue.Queue"] = [
            queue.Queue() for _ in range(cfg.num_workers)
        ]
        self.workers: List[Worker] = []
        self._started = 0
        self._sampler_iter: Iterator[BatchIndices] = iter(loader.sampler)
        self._next_worker = 0
        self._dispatched = 0
        self._received = 0
        self._next_bid: Optional[int] = None  # set on first dispatched batch
        self._reorder: Dict[int, Any] = {}
        self._exhausted = False
        self._shutdown = False
        self._lock = threading.Lock()

        if loader.autotuner is not None:
            # knob callbacks reach this iterator through a weakref: a strong
            # closure would pin an abandoned iterator (and its worker
            # threads) on the loader-lived autotuner until the next bind()
            _wget, _wset = make_weak_knob_callbacks(self)
            loader.autotuner.bind(
                build_loader_knobs(
                    at,
                    get_fetch=_wget(lambda it: it._fetch_workers),
                    set_fetch=_wset(lambda it, n: it._set_fetch_workers(n)),
                    get_outstanding=_wget(lambda it: it.max_outstanding),
                    set_outstanding=_wset(lambda it, n: it._set_outstanding(n)),
                    hedge=loader.hedge,
                    max_fetch_workers=self._max_fetch_bound,
                    max_outstanding=self._max_outstanding_bound,
                )
            )
            # bind() replaced the knob list; the cache knobs ride along every
            # epoch (attach_knob re-applies learned values and keeps a
            # quiescent controller parked for knobs it has seen)
            for knob in loader._cache_knobs:
                loader.autotuner.attach_knob(knob)

        if not cfg.lazy_init:
            # Vanilla blocking behaviour: the constructor sequentially starts
            # every worker and waits for each to come up (paper Fig. 8 left).
            for i in range(cfg.num_workers):
                w = self._make_worker(i)
                w.start()
                w.ready.wait()
            self._dispatch()

    # -- autotuner control surfaces (applied between batches) ----------------
    def _set_fetch_workers(self, n: int) -> int:
        at = self.cfg.autotune
        n = max(at.min_fetch_workers, min(int(n), self._max_fetch_bound))
        applied = n
        for w in self.workers:
            applied = w.fetcher.resize(n)
        self._fetch_workers = applied if self.workers else n
        self.loader._tuned["fetch_workers"] = self._fetch_workers
        return self._fetch_workers

    def _set_outstanding(self, n: int) -> int:
        at = self.cfg.autotune
        n = max(at.min_outstanding, min(int(n), self._max_outstanding_bound))
        self.max_outstanding = n
        self.loader._tuned["outstanding"] = n
        return n

    # -- worker management ----------------------------------------------------
    def _make_worker(self, i: int) -> Worker:
        cfg = self.cfg
        w = Worker(
            i,
            self.loader.dataset,
            make_fetcher(cfg.impl, self._fetch_workers, hedge=self.loader.hedge,
                         hard_cap=self._fetch_hard_cap),
            self.index_queues[i],
            self.data_queue,
            collate_fn=self.loader.collate_fn,
            tracer=self.tracer,
            startup_cost_s=self.loader.worker_startup_cost_s,
            batch_pool=cfg.batch_pool if cfg.impl == "threaded" else 0,
        )
        self.workers.append(w)
        self._started += 1
        return w

    def _start_download(self) -> None:
        """Lazy path (paper Fig. 8 right): create workers without blocking,
        feeding indices to the ones that already exist."""
        while self._started < self.cfg.num_workers:
            w = self._make_worker(self._started)
            w.start()  # worker sleeps its own startup cost concurrently
            self._dispatch()

    # -- index dispatch ---------------------------------------------------------
    def _dispatch(self) -> None:
        if self._exhausted or not self.workers:
            return
        while self._dispatched - self._received < self.max_outstanding:
            try:
                task = next(self._sampler_iter)
            except StopIteration:
                self._exhausted = True
                return
            except ClaimStarved:
                # elastic sampler: peers hold every remaining shard; keep
                # delivering what is in flight and retry on a later dispatch
                return
            if self._next_bid is None:
                self._next_bid = task.batch_id
            # Round-robin over ALL worker queues (PyTorch's
            # _worker_queue_idx_cycle).  Queues exist from construction, so a
            # lazily-started worker finds its backlog when it comes up.
            wq = self.index_queues[self._next_worker % len(self.index_queues)]
            self._next_worker += 1
            wq.put(task)
            self._dispatched += 1

    # -- iteration ---------------------------------------------------------------
    def __iter__(self) -> "_LoaderIter":
        return self

    def __next__(self) -> Any:
        return deliver_traced(self)

    def _next_impl(self) -> Any:
        if self._shutdown:
            raise StopIteration
        if self.cfg.lazy_init and self._started < self.cfg.num_workers:
            self._start_download()
        self._dispatch()
        deadline = time.monotonic() + self.cfg.timeout_s
        while True:
            if self._next_bid is not None and self._next_bid in self._reorder:
                batch = self._reorder.pop(self._next_bid)
                self._next_bid += 1
                self.loader._consumed = self._next_bid
                self._dispatch()
                return batch
            if (
                self._exhausted
                and self._received >= self._dispatched
                and not self._reorder
            ):
                self._finish_epoch()
                raise StopIteration
            try:
                bid, payload = self.data_queue.get(timeout=0.1)
            except queue.Empty:
                if self._shutdown:
                    # shut down from another thread (the device ring's
                    # close) while this consumer waited
                    raise StopIteration from None
                if time.monotonic() > deadline:
                    self.shutdown()
                    raise LoaderTimeout(
                        f"no batch within {self.cfg.timeout_s}s "
                        f"(dispatched={self._dispatched}, received={self._received})"
                    ) from None
                # a claim-starved elastic sampler returns from _dispatch
                # without marking exhaustion: retry it while idle, so a shard
                # freed by a peer's departure is picked up
                self._dispatch()
                continue
            self._received += 1
            if isinstance(payload, WorkerFailure):
                self.shutdown()
                raise payload.exc
            self._reorder[bid] = payload

    def _finish_epoch(self) -> None:
        self.shutdown()
        self.loader._note_epoch_end()

    # -- shutdown ------------------------------------------------------------
    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        for q in self.index_queues:
            q.put(_SENTINEL)
        for w in self.workers:
            w.stop.set()
        for w in self.workers:
            w.join(timeout=2.0)

    def __del__(self) -> None:  # pragma: no cover - best effort
        try:
            self.shutdown()
        except Exception:
            pass
