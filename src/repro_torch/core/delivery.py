"""Device-sharded batch delivery: per-mesh-slice assembler lanes.

The staged pipeline (:mod:`repro_torch.core.pipeline`) completes samples out
of order; host delivery collects them into one host batch and leaves the
copy to the card to the device prefetch ring, one full-batch transfer on
one thread.  Sharded delivery, as the reference's
(``repro/core/delivery.py``), overlaps collate and transfer per device
instead.

One assembler **lane** per data-axis slice of the mesh.  The pipeline's
consumer routes each completed sample to its lane by batch position (lane
``l`` owns the ``l``-th contiguous slice, matching
:func:`repro_torch.core.sampler.shard_plan`, so the composed batch holds the
host path's rows in the host path's order).  As soon as a lane's slice of a
batch is complete, the lane's own thread collates it (into its own pool of
staging buffers with ``staging_buffers > 0``) and copies it to its device
through pinned host memory on the lane's own CUDA stream, straight into its
row slice of the batch's tensors, then synchronizes that stream: the rows
have landed before the lane reports.  The last lane to finish hands the
batch back to the pipeline's completion queue as a
:class:`~repro_torch.core.pipeline._Composed` token, so strict in-order
delivery holds end to end.  Composing copies nothing.

The batch's tensors are allocated on the stream of the lane that gets there
first.  When the loader yields the batch (:meth:`ShardedAssembler.hand_off`)
every tensor is ``record_stream``-ed on the current stream of the thread
that takes it, so whatever that consumer does with it, the caching
allocator hands the block back to the lanes only once the work that stream
had queued when the batch was freed is done; a consumer that moves the
batch on to other streams marks it there too (the device prefetch ring
does, for its epilogue's stream and the training step's).  A block
allocated on the training step's stream instead could come straight from
the step's freed temporaries while its queued kernels still read them, and
a lane's copy on its own stream would overwrite them.
Lanes on one device write disjoint rows of one tensor there; one process
cannot build one tensor across cards, so a plan whose lanes lie on
distinct devices of one process is refused (:meth:`LanePlan.compose_device`).
A global batch that spans processes is composed one process a card: over
a process group (:mod:`repro_torch.launch.dist`) whose world size is the
plan's ``global_mult``, each rank composes its own rows on its own card,
and the ranks' rows in rank order are the global batch (the data-parallel
step reduces over them).  On the CPU the rows are plain copies.

Multi-host alignment reuses the coord layer: each host publishes its cursor
to a :class:`ShardCursorBoard` (an append log under the shared coord dir),
and a checkpoint resumes from the fleet-minimum batch boundary.

The module imports no torch at import (the loader builds a
:class:`LanePlan` in the constructor); the lane threads import it.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pipeline import _Composed, _Failure
from repro_torch.core.shm import release_items
from repro_torch.core.tracing import LANE_COLLATE, LANE_H2D, NULL_TRACER, STAGE_COMPOSE, Tracer
from repro_torch.models.sharding import NamedSharding


def device_id(d: Any) -> int:
    """A device's number, as the reference's ``Device.id``: a CUDA device's
    index (a CPU device is 0)."""
    did = getattr(d, "id", None)
    if did is not None:
        return int(did)
    return int(d.index) if getattr(d, "index", None) is not None else 0


def _device_key(d: Any) -> Tuple[Any, ...]:
    return (getattr(d, "type", None), getattr(d, "index", None), getattr(d, "id", None))


class LanePlan:
    """Static mapping from host-batch positions to mesh data-axis lanes.

    A lane is one coordinate along ``axis`` restricted to this process's
    devices; its device list is every such device with that coordinate (the
    batch is replicated over the other axes).  A ``torch.device`` belongs to
    this process; a device object with a ``process_index`` (another rank's
    element of a process mesh, or the reference tests' fake meshes) belongs
    to that process."""

    def __init__(self, mesh: Any, axis: str, lanes: List[List[Any]], host_rows: int,
                 process_index: int = 0) -> None:
        self.mesh = mesh
        self.axis = axis
        self.lanes = lanes
        self.num_lanes = len(lanes)
        self.host_rows = host_rows
        self.process_index = process_index
        self.axis_size = int(mesh.shape[axis])
        # rows of the composed global batch per host row: a process-local
        # mesh composes exactly the host batch
        self.global_mult = self.axis_size // self.num_lanes

    @staticmethod
    def build(spec: Any, host_rows: int, *, process_index: Optional[int] = None) -> "LanePlan":
        mesh = spec.mesh
        if mesh is None:
            raise ValueError(
                "DeliverySpec(kind='sharded') needs a mesh: pass "
                "DeliverySpec.sharded(mesh, axis=...), or construct via "
                "repro_torch.core.make_loader which builds one from RunConfig.mesh"
            )
        if spec.axis not in mesh.axis_names:
            raise ValueError(
                f"delivery axis {spec.axis!r} is not a mesh axis {tuple(mesh.axis_names)}"
            )
        ax = list(mesh.axis_names).index(spec.axis)
        if process_index is None:
            from repro_torch.launch import dist

            process_index = dist.rank()
        pid = process_index
        groups: Dict[int, List[Any]] = {}
        for coords, d in np.ndenumerate(mesh.devices):
            if getattr(d, "process_index", pid) == pid:
                groups.setdefault(int(coords[ax]), []).append(d)
        if not groups:
            raise ValueError("mesh has no devices addressable from this process")
        lanes = [groups[k] for k in sorted(groups)]
        if int(mesh.shape[spec.axis]) % len(lanes):
            raise ValueError(
                f"this process addresses {len(lanes)} slices of mesh axis "
                f"{spec.axis!r} (size {mesh.shape[spec.axis]}), which do not divide it "
                "evenly: sharded delivery needs a uniform process layout along the data axis"
            )
        if host_rows % len(lanes):
            raise ValueError(
                f"host batch of {host_rows} rows does not divide evenly into the "
                f"{len(lanes)} local slices of mesh axis {spec.axis!r}; pick batch_size "
                "so every lane gets an equal shard"
            )
        return LanePlan(mesh, spec.axis, lanes, host_rows, pid)

    def sharding_for(self, ndim: int) -> NamedSharding:
        """Batch-dim sharding over ``axis``, replicated elsewhere."""
        return NamedSharding(self.mesh, (self.axis, *([None] * (ndim - 1))))

    def global_rows(self, host_rows: int) -> int:
        return host_rows * self.global_mult

    def compose_device(self) -> Any:
        """The one device this process's lanes write their rows on.  Raises
        ``ValueError`` for lanes on distinct devices of this process (one
        process composes one tensor on one device: run one process a card),
        and for a global batch that spans processes when no process group
        of ``global_mult`` ranks is up to hold the other rows."""
        devices = {_device_key(d): d for lane in self.lanes for d in lane}
        if len(devices) != 1:
            raise ValueError(
                f"sharded delivery composes one tensor on one device a process; this plan's "
                f"{self.num_lanes} lanes span {len(devices)} devices of one process: run one "
                "process a card (repro_torch.launch.dist) or use a mesh whose lanes share "
                "one device")
        if self.global_mult != 1:
            from repro_torch.launch import dist

            if dist.world_size() != self.global_mult:
                raise ValueError(
                    f"this plan's global batch spans {self.global_mult} processes, but the "
                    f"process group has {dist.world_size()} rank(s): start one process a card "
                    "in a group of that size (repro_torch.launch.dist.init_process_group)")
        return next(iter(devices.values()))


class _Assembly:
    """Per-batch lane state.  ``lane_slots``/``lane_left`` are touched only
    by the pipeline's consumer thread; ``out``/``lanes_pending`` are shared
    with the lane threads under the assembler lock."""

    __slots__ = ("host_rows", "per", "lane_slots", "lane_left", "lanes_pending", "out")

    def __init__(self, num_lanes: int, host_rows: int) -> None:
        self.host_rows = host_rows
        self.per = host_rows // num_lanes
        self.lane_slots: List[Optional[List[Any]]] = [[None] * self.per for _ in range(num_lanes)]
        self.lane_left = [self.per] * num_lanes
        self.lanes_pending = num_lanes
        self.out: Optional[Dict[str, Any]] = None


class ShardedAssembler:
    """Lane threads turning completed samples into composed device batches.

    Contract with :class:`~repro_torch.core.pipeline._PipelineIter`:

    * ``begin_batch``/``add`` are called from the pipeline's consumer thread
      only (the thread that owns the strict reorder state);
    * finished batches come back through ``done_q`` as
      ``(_Composed(batch_id), batch)``, or ``(_Composed, _Failure)`` when a
      lane fails, which the consumer raises like a stage failure.
    """

    def __init__(
        self,
        plan: LanePlan,
        collate_fn: Callable,
        *,
        done_q: "queue.Queue",
        stop: threading.Event,
        tracer: Tracer = NULL_TRACER,
        staging_buffers: int = 0,
    ) -> None:
        import torch

        self.plan = plan
        self.collate_fn = collate_fn
        self.done_q = done_q
        self.stop = stop
        self.tracer = tracer
        self.device = torch.device(plan.compose_device())
        self._cuda = self.device.type == "cuda"
        # one CUDA stream a lane: lanes' copies overlap one another and the
        # training step's stream
        self._streams = ([torch.cuda.Stream(self.device) for _ in range(plan.num_lanes)]
                         if self._cuda else [None] * plan.num_lanes)
        # pinned staging (repro_torch.core.staging): each lane collates into
        # its own pool, whose sets its copies read pinned in place, released
        # once the lane's copy has landed
        self._pools = None
        if staging_buffers > 0:
            from repro_torch.core.staging import HostBatchPool

            self._pools = [HostBatchPool(depth=staging_buffers)
                           for _ in range(plan.num_lanes)]
        self._lock = threading.Lock()
        self._batches: Dict[int, _Assembly] = {}
        self._lane_qs: List["queue.Queue"] = [queue.Queue() for _ in range(plan.num_lanes)]
        self._composed = [0] * plan.num_lanes
        self._collate_s = [0.0] * plan.num_lanes
        self._h2d_s = [0.0] * plan.num_lanes
        self._h2d_bytes = [0] * plan.num_lanes
        self._threads = [
            threading.Thread(target=self._lane_main, args=(i,), name=f"delivery-lane-{i}",
                             daemon=True)
            for i in range(plan.num_lanes)
        ]
        for t in self._threads:
            t.start()

    # -- consumer-thread surface ---------------------------------------------
    def begin_batch(self, batch_id: int, host_rows: int) -> None:
        if host_rows % self.plan.num_lanes:
            raise ValueError(
                f"batch {batch_id} has {host_rows} rows, not divisible into "
                f"{self.plan.num_lanes} lanes (a drop_last=False tail batch: sharded "
                "delivery requires uniform shards)"
            )
        with self._lock:
            self._batches[batch_id] = _Assembly(self.plan.num_lanes, host_rows)

    def add(self, batch_id: int, pos: int, item: Any) -> None:
        with self._lock:
            a = self._batches[batch_id]
        lane = pos // a.per
        a.lane_slots[lane][pos - lane * a.per] = item
        a.lane_left[lane] -= 1
        if a.lane_left[lane] == 0:
            items = a.lane_slots[lane]
            a.lane_slots[lane] = None  # the lane thread owns these now
            self._lane_qs[lane].put((batch_id, items))

    def hand_off(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The composed ``batch``, each CUDA tensor marked as used by the
        calling thread's current stream (the lanes allocated it on theirs);
        called as the loader yields it."""
        if self._cuda:
            import torch

            stream = torch.cuda.current_stream(self.device)
            for t in batch.values():
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(stream)
        return batch

    # -- lane threads ---------------------------------------------------------
    def _outputs(self, a: _Assembly, sub: Dict[str, np.ndarray], stream: Any) -> Dict[str, Any]:
        """This process's rows of the batch (the whole batch in one process),
        allocated by the first lane to get here, on that lane's stream."""
        import torch

        with self._lock:
            if a.out is None:
                rows = a.host_rows
                with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                    a.out = {k: torch.empty((rows, *v.shape[1:]),
                                            dtype=torch.from_numpy(v[:0]).dtype,
                                            device=self.device)
                             for k, v in sub.items()}
            return a.out

    def _lane_main(self, lane: int) -> None:
        import torch

        q = self._lane_qs[lane]
        stream = self._streams[lane]
        while not self.stop.is_set():
            try:
                batch_id, items = q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                t0 = time.monotonic()
                if self._pools is not None:
                    sub = self._pools[lane].collate(items)
                else:
                    sub = self.collate_fn(items)
                t1 = time.monotonic()
                self.tracer.record(LANE_COLLATE, t0, t1, lane=lane, batch_id=batch_id)
                # collate copied the views out: shm slots go back to their workers
                release_items(items)
                with self._lock:
                    a = self._batches[batch_id]
                out = self._outputs(a, sub, stream)
                rows = slice(lane * a.per, (lane + 1) * a.per)
                t1b = time.monotonic()
                if self._cuda:
                    pin = getattr(sub, "pin", None)
                    host = (pin()[0] if pin is not None else
                            {k: torch.from_numpy(np.asarray(v)).pin_memory()
                             for k, v in sub.items()})
                    with torch.cuda.stream(stream):
                        for k, t in host.items():
                            out[k][rows].copy_(t, non_blocking=True)
                    # the rows have landed before the lane reports, and
                    # before the staging set goes back to its pool
                    stream.synchronize()
                else:
                    for k, v in sub.items():
                        out[k][rows].copy_(torch.from_numpy(np.asarray(v)))
                t2 = time.monotonic()
                nbytes = sum(int(np.asarray(v).nbytes) for v in sub.values())
                self.tracer.record(LANE_H2D, t1b, t2, lane=lane, batch_id=batch_id,
                                   bytes=nbytes)
                release = getattr(sub, "release_after", None)
                if release is not None:
                    release([out[k][rows] for k in out])  # copied out: recycled
                with self._lock:
                    self._collate_s[lane] += t1 - t0
                    self._h2d_s[lane] += t2 - t1b
                    self._h2d_bytes[lane] += nbytes
                    self._composed[lane] += 1
                    a.lanes_pending -= 1
                    last = a.lanes_pending == 0
                if last:
                    self._compose(batch_id)
            except BaseException as e:  # surfaced on the consumer thread
                self.done_q.put((_Composed(batch_id), _Failure(e)))

    def _compose(self, batch_id: int) -> None:
        with self._lock:
            a = self._batches.pop(batch_id)
        with self.tracer.span(STAGE_COMPOSE, batch_id=batch_id):
            # every lane wrote its rows of the same tensors: nothing to copy
            batch = dict(a.out)
        self.done_q.put((_Composed(batch_id), batch))

    # -- observability / shutdown ---------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            composed = list(self._composed)
            collate_s = list(self._collate_s)
            h2d_s = list(self._h2d_s)
            h2d_bytes = list(self._h2d_bytes)
        lanes = []
        for i in range(self.plan.num_lanes):
            n = composed[i]
            lanes.append({
                "lane": i,
                "devices": [device_id(d) for d in self.plan.lanes[i]],
                "composed": n,
                "collate_mean_s": collate_s[i] / n if n else 0.0,
                "h2d_mean_s": h2d_s[i] / n if n else 0.0,
                "h2d_bytes": h2d_bytes[i],
                "queued": self._lane_qs[i].qsize(),
            })
        out = {
            "axis": self.plan.axis,
            "num_lanes": self.plan.num_lanes,
            "device": str(self.device),
            "lanes": lanes,
            # lane skew in composed batches: > 1 means one mesh slice is
            # starving the compose barrier; the signal autotune watches
            "lane_skew": max(composed) - min(composed) if composed else 0,
        }
        if self._pools is not None:
            out["staging"] = [{**p.stats(), "registered": p.registered} for p in self._pools]
        return out

    def close(self) -> None:
        self.stop.set()
        for t in self._threads:
            t.join(timeout=2.0)


def _cursor_apply(st: Dict[str, Any], rec: Dict[str, Any]) -> None:
    op = rec.get("op")
    if op == "pub":
        st[str(rec["h"])] = [int(rec["e"]), int(rec["b"])]
    elif op == "snap":
        st.clear()
        st.update({str(h): [int(e), int(b)] for h, (e, b) in rec["c"].items()})


class ShardCursorBoard:
    """Fleet-wide per-shard cursor alignment (coord-layer substrate).

    Every host publishes ``(epoch, next_batch)`` as a record on the shared
    append log (compacted to a per-host snapshot periodically);
    :meth:`aligned` is the fleet minimum, the newest batch boundary every
    host has delivered.  A checkpoint cut on any host resumes the whole
    fleet from that boundary, so the restored global batch is consistent
    without a gather."""

    def __init__(self, coord_dir: str, *, num_hosts: int = 1) -> None:
        from repro_torch.core.coord import AppendLog

        self.num_hosts = max(int(num_hosts), 1)
        self._log = AppendLog(
            coord_dir,
            "shard_cursors",
            make_state=dict,
            apply=_cursor_apply,
            snapshot=lambda st: [{"op": "snap", "c": st}],
            compact_every=256,
        )

    def publish(self, host_id: int, epoch: int, next_batch: int) -> None:
        with self._log.update() as (_st, emit):
            emit({"op": "pub", "h": int(host_id), "e": int(epoch), "b": int(next_batch)})

    def aligned(self) -> Optional[Tuple[int, int]]:
        """The ``(epoch, next_batch)`` every host has reached, or None until
        all ``num_hosts`` cursors have been published."""
        with self._log.view() as st:
            doc = dict(st)
        if len(doc) < self.num_hosts:
            return None
        return min(tuple(int(x) for x in v) for v in doc.values())
