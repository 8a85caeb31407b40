"""Staged streaming pipeline — the loader behind ``LoaderConfig.pipeline``.

The legacy worker/fetcher path treats ``dataset[i]`` as one opaque unit, so
network fetch, decode and augmentation all run on the same fetch thread:
slow CPU preprocessing blocks IO concurrency, a straggler GET parks the
CPU, and a worker's whole thread pool idles through the tail of every batch.
This module splits the item path into an explicit stage graph::

    sampler -> [fetch-raw | IO executor] -> bounded queue
            -> [decode -> augment | CPU executor] -> completion queue
            -> [assembler: collate] -> consumer (-> device prefetch ring)

* **IO executor** — thread pool or asyncio event loop (``LoaderConfig.impl``)
  gated by an :class:`AdjustableSemaphore`, with optional hedged duplicates
  for straggler GETs (:class:`~repro_torch.core.fetcher.HedgeTracker`).
* **CPU executor** — ``decode_raw`` + ``augment_item`` on a gated thread
  pool (``PipelineConfig.cpu_executor="thread"``) or a spawn-based worker
  process pool (``"process"``: needs a picklable dataset, persists across
  epochs on the loader, respawns crashed workers and retries only their
  in-flight sample).  Datasets that cannot split run the monolithic
  ``__getitem__`` on the IO executor.
* **Out-of-order completion** — samples finish in whatever order storage and
  CPU allow; the assembler composes batches per ``PipelineConfig.reorder``:
  ``"strict"`` rebuilds exactly the legacy stream (bit-identical),
  ``"window"`` fills each group of ``reorder_window`` batch slots with
  whichever of the group's samples finish first.
* **Per-stage observability** — ``stage_fetch`` / ``stage_decode`` /
  ``stage_augment`` spans per sample, a ``stage_collate`` span per batch,
  and queue occupancy in :meth:`_PipelineIter.stage_stats`.
* **Pinned staging** — with ``staging_buffers > 0`` the default collate
  writes into a :class:`~repro_torch.core.staging.HostBatchPool`, whose
  sets a CUDA device prefetch ring pins in place.
* **Live knobs** — with ``LoaderConfig.autotune`` enabled, the loader's
  :class:`~repro_torch.core.autotune.AutotuneController` resizes the IO and
  CPU executors, the outstanding window, the fetch->decode queue and the
  reorder window between batches, or, under ``thread_budget``, one coupled
  io/cpu split and the CPU executor kind (thread or process, swapped live).

The pipeline carries the loader's cache knobs into each epoch's knob list
and reports each drained epoch to the loader (``_note_epoch_end``), which
feeds the epoch-cadence cache controller.  A trimmed copy of the
reference's pipeline, with its shared-memory transport
(``PipelineConfig.transport="shm"``, :mod:`repro_torch.core.shm`: decoded
samples come back as views into a slab the parent owns, and the slab's
usable slots are an autotune knob) and its sharded lanes
(``LoaderConfig.delivery`` sharded, :mod:`repro_torch.core.delivery`: the
consumer routes each completed sample to its mesh lane, whose thread
collates and copies its rows to the card, and the composed batch comes back
through the completion queue as a :class:`_Composed` token; strict reorder
only).  The module imports no ``torch``: ``spawn`` re-imports it in every
CPU worker process, and the delivery module imports torch in its lane
threads only.
"""
from __future__ import annotations

import asyncio
import math
import multiprocessing
import pickle
import queue
import os
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from multiprocessing.connection import wait as _mp_wait
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import shm as shm_mod
from repro_torch.core.autotune import (
    build_budget_knobs,
    build_pipeline_knobs,
    make_weak_knob_callbacks,
)
from repro_torch.core.fetcher import (
    AdjustableSemaphore,
    aretry_transient,
    retry_transient,
)
from repro_torch.core.sampler import BatchIndices
from repro_torch.core.staging import HostBatchPool
from repro_torch.core.tracing import (
    BYTES_COPIED,
    SHUFFLE_ENTROPY,
    STAGE_AUGMENT,
    STAGE_COLLATE,
    STAGE_DECODE,
    STAGE_FETCH,
)
from repro_torch.core.utilization import available_cpu_count
from repro_torch.data.dataset import collate


class _Sample:
    """One flattened unit of work flowing through the stage graph."""

    __slots__ = ("batch_id", "pos", "index", "raw")

    def __init__(self, batch_id: int, pos: int, index: int) -> None:
        self.batch_id = batch_id
        self.pos = pos
        self.index = index
        self.raw: Any = None


class _Failure:
    """Exception carrier routed through the completion queue."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class _Composed:
    """Completion-queue token for a fully composed device batch (sharded
    delivery, :mod:`repro_torch.core.delivery`).  Defined here so the
    pipeline's hot loop can type-check it without importing the delivery
    module."""

    __slots__ = ("batch_id",)

    def __init__(self, batch_id: int) -> None:
        self.batch_id = batch_id


class _BoundedQ:
    """FIFO whose capacity is an :class:`AdjustableSemaphore`, so queue depth
    is a live autotune knob.  ``put`` blocks while the downstream stage is
    full (polling the pipeline stop event): that stall, propagating back to
    the IO gate, is the pipeline's backpressure.  Tracks occupancy so the
    bottleneck stage is visible (a full fetch->decode queue = CPU-bound, an
    empty one = IO-bound)."""

    def __init__(self, depth: int, stop: threading.Event) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._cap = AdjustableSemaphore(max(1, depth))
        self._stop = stop
        self._lock = threading.Lock()
        self._occ_sum = 0
        self._occ_n = 0
        self._occ_max = 0

    @property
    def depth(self) -> int:
        return self._cap.limit

    def resize(self, depth: int, hi: int) -> int:
        d = max(1, min(int(depth), hi))
        self._cap.set_limit(d)
        return d

    def _note(self) -> None:
        size = self._q.qsize()
        with self._lock:
            self._occ_sum += size
            self._occ_n += 1
            self._occ_max = max(self._occ_max, size)

    def put(self, item: Any) -> bool:
        while not self._cap.acquire(timeout=0.1):
            if self._stop.is_set():
                return False
        self._q.put(item)
        self._note()
        return True

    def get(self, timeout: float = 0.1) -> Any:
        item = self._q.get(timeout=timeout)  # queue.Empty passes through
        self._cap.release()
        self._note()
        return item

    def occupancy(self) -> Dict[str, float]:
        with self._lock:
            mean = self._occ_sum / self._occ_n if self._occ_n else 0.0
            return {
                "depth": self._cap.limit,
                "now": self._q.qsize(),
                "mean": round(mean, 2),
                "max": self._occ_max,
            }


# ---------------------------------------------------------------------------
# IO stage
# ---------------------------------------------------------------------------


class _IOStage:
    """Fetch-raw stage: a dedicated IO executor (thread pool or asyncio loop)
    gated by an :class:`AdjustableSemaphore`.

    Admission is caller-side: :meth:`submit` parks samples in a pending deque
    and ``_kick`` moves them onto the executor only when a gate permit is
    free, so a ``resize`` takes effect at the next admission.  The permit
    is held across the fetch AND the (possibly blocking) hand-off into the
    fetch->decode queue: when decode backs up, IO concurrency drains to
    zero instead of buffering unboundedly.

    Hedging (both modes): the assembler loop calls :meth:`hedge_scan`; any
    in-flight fetch older than the p95 deadline gets one ungated duplicate
    (on the pool's headroom threads, or as an extra coroutine on the event
    loop) and the first completion wins via the shared ``_inflight`` pop.
    """

    def __init__(
        self,
        dataset,
        *,
        mode: str,  # "threaded" | "asyncio"
        width: int,
        hard_cap: int,
        split: bool,
        decode_q: _BoundedQ,
        done_q: "queue.Queue",
        tracer,
        hedge=None,
    ) -> None:
        self.dataset = dataset
        self.split = split
        self.decode_q = decode_q
        self.done_q = done_q
        self.tracer = tracer
        self.hedge = hedge
        self.hard_cap = max(width, hard_cap)
        self.gate = AdjustableSemaphore(width)
        self._pending: deque = deque()
        self._lock = threading.Lock()
        # in-flight registry: id(sample) -> (sample, t0).  Doubles as the
        # first-response-wins arbiter for hedged fetches: whichever copy
        # pops the entry owns the sample; the loser drops its result.
        self._inflight: Dict[int, Tuple[_Sample, float]] = {}
        if mode == "asyncio":
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._loop.run_forever, name="pipe-io-loop", daemon=True
            )
            self._thread.start()
            self._pool = None
        else:
            self._loop = None
            # +2 headroom threads so hedge duplicates can run while every
            # gated slot is busy with stragglers
            self._pool = ThreadPoolExecutor(
                max_workers=self.hard_cap + 2, thread_name_prefix="pipe-io"
            )

    # -- admission -----------------------------------------------------------
    def submit(self, sample: _Sample) -> None:
        with self._lock:
            self._pending.append(sample)
        self._kick()

    def _kick(self) -> None:
        while True:
            with self._lock:
                if not self._pending or not self.gate.acquire(timeout=0):
                    return
                s = self._pending.popleft()
            if self._loop is not None:
                asyncio.run_coroutine_threadsafe(self._afetch(s), self._loop)
            else:
                self._pool.submit(self._run_fetch, s)

    def resize(self, width: int) -> int:
        w = max(1, min(int(width), self.hard_cap))
        self.gate.set_limit(w)
        self._kick()  # a raised limit admits parked samples immediately
        return w

    # -- completion (first response wins when hedged) ------------------------
    def _complete(self, s: _Sample, raw: Any) -> bool:
        """Route a finished fetch downstream; returns False when the other
        copy of a hedged fetch already claimed the sample."""
        with self._lock:
            if self._inflight.pop(id(s), None) is None:
                return False
        if self.split:
            s.raw = raw
            self.decode_q.put(s)
        else:
            self.done_q.put((s, raw))  # raw IS the finished item (monolithic)
        return True

    def _fail(self, s: _Sample, exc: BaseException) -> None:
        with self._lock:
            if self._inflight.pop(id(s), None) is None:
                return  # a hedge duplicate already delivered this sample
        self.done_q.put((s, _Failure(exc)))

    # -- threaded fetch ------------------------------------------------------
    def _fetch_value(self, s: _Sample) -> Any:
        if self.split:
            return retry_transient(self.dataset.get_raw, s.index)
        return retry_transient(self.dataset.__getitem__, s.index)

    def _run_fetch(self, s: _Sample) -> None:
        t0 = time.monotonic()
        with self._lock:
            self._inflight[id(s)] = (s, t0)
        try:
            raw = self._fetch_value(s)
            t1 = time.monotonic()
            self.tracer.record(STAGE_FETCH, t0, t1, index=s.index,
                               batch_id=s.batch_id)
            if self.hedge is not None:
                self.hedge.observe(t1 - t0)
            self._complete(s, raw)
        except BaseException as e:  # routed to the consumer, which re-raises
            self._fail(s, e)
        finally:
            self.gate.release()
            self._kick()

    def _run_hedge(self, s: _Sample) -> None:
        """Ungated duplicate of a straggling fetch; first completion wins."""
        t0 = time.monotonic()
        try:
            raw = self._fetch_value(s)
            self.tracer.record(STAGE_FETCH, t0, time.monotonic(),
                               index=s.index, batch_id=s.batch_id, hedge=True)
            if self._complete(s, raw) and self.hedge is not None:
                self.hedge.hedges_won += 1
        except Exception:
            pass  # the original is still in flight; let it decide the outcome

    def hedge_scan(self) -> None:
        """Issue duplicates for fetches past the p95 deadline (called from
        the assembler loop, so hedging needs no timer thread)."""
        if self.hedge is None or not self.hedge.enabled:
            return
        deadline = self.hedge.deadline()
        now = time.monotonic()
        stale: List[_Sample] = []
        with self._lock:
            for s, t0 in self._inflight.values():
                if now - t0 > deadline:
                    stale.append(s)
            for s in stale:  # re-arm so one straggler hedges only once
                self._inflight[id(s)] = (s, now + 3600.0)
        for s in stale:
            self.hedge.hedges_issued += 1
            if self._loop is not None:
                asyncio.run_coroutine_threadsafe(self._ahedge(s), self._loop)
            else:
                self._pool.submit(self._run_hedge, s)

    # -- asyncio fetch -------------------------------------------------------
    async def _acomplete(self, s: _Sample, raw: Any) -> bool:
        """Async mirror of :meth:`_complete`: the (possibly blocking)
        decode-queue hand-off runs in an executor so other in-flight GETs
        keep progressing on the event loop."""
        with self._lock:
            if self._inflight.pop(id(s), None) is None:
                return False
        if self.split:
            s.raw = raw
            await asyncio.get_running_loop().run_in_executor(
                None, self.decode_q.put, s
            )
        else:
            self.done_q.put((s, raw))
        return True

    async def _afetch(self, s: _Sample) -> None:
        t0 = time.monotonic()
        with self._lock:
            self._inflight[id(s)] = (s, t0)
        try:
            fetch = self.dataset.aget_raw if self.split else self.dataset.aget_item
            raw = await aretry_transient(fetch, s.index)
            t1 = time.monotonic()
            self.tracer.record(STAGE_FETCH, t0, t1,
                               index=s.index, batch_id=s.batch_id)
            if self.hedge is not None:
                self.hedge.observe(t1 - t0)
            await self._acomplete(s, raw)
        except asyncio.CancelledError:
            raise  # loop teardown at shutdown: nobody waits for this sample
        except BaseException as e:  # routed to the consumer, which re-raises
            self._fail(s, e)
        finally:
            self.gate.release()
            self._kick()

    async def _ahedge(self, s: _Sample) -> None:
        """Ungated asyncio duplicate of a straggling fetch; first wins."""
        t0 = time.monotonic()
        try:
            fetch = self.dataset.aget_raw if self.split else self.dataset.aget_item
            raw = await aretry_transient(fetch, s.index)
            self.tracer.record(STAGE_FETCH, t0, time.monotonic(),
                               index=s.index, batch_id=s.batch_id, hedge=True)
            if await self._acomplete(s, raw) and self.hedge is not None:
                self.hedge.hedges_won += 1
        except Exception:
            pass  # the original is still in flight; let it decide the outcome

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        if self._loop is not None:
            def _cancel_and_stop() -> None:
                # cancel in-flight coroutines before stopping so loop
                # teardown doesn't destroy pending tasks mid-await
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()
                self._loop.call_soon(self._loop.stop)

            self._loop.call_soon_threadsafe(_cancel_and_stop)
            self._thread.join(timeout=5)
            if not self._loop.is_running():
                self._loop.close()


# ---------------------------------------------------------------------------
# CPU stage
# ---------------------------------------------------------------------------


class _CPUStage:
    """decode + augment on a dedicated gated thread pool.  The gate is
    acquired BEFORE pulling from the fetch->decode queue, so a surplus
    thread waits empty-handed rather than holding a sample hostage, and a
    shrinking ``resize`` drains as permits are released.

    Threads are spawned lazily up to the CURRENT width (at most
    ``hard_cap``): a ceiling of 32 costs no idle threads at width 4.
    ``active=False`` parks the stage (threads idle without pulling work):
    the iterator flips it when the ``cpu_executor`` knob swaps the CPU stage
    to the process pool; in-flight samples still finish here."""

    def __init__(
        self,
        dataset,
        *,
        width: int,
        hard_cap: int,
        decode_q: _BoundedQ,
        done_q: "queue.Queue",
        stop: threading.Event,
        tracer,
    ) -> None:
        self.dataset = dataset
        self.decode_q = decode_q
        self.done_q = done_q
        self.stop = stop
        self.tracer = tracer
        self.hard_cap = max(width, hard_cap)
        self.gate = AdjustableSemaphore(max(1, width))
        self.active = True
        self.threads: List[threading.Thread] = []
        self._spawn_lock = threading.Lock()
        self._ensure_threads(width)

    @property
    def width(self) -> int:
        return self.gate.limit

    def _ensure_threads(self, width: int) -> None:
        with self._spawn_lock:
            while len(self.threads) < min(max(width, 1), self.hard_cap):
                t = threading.Thread(
                    target=self._run, name=f"pipe-cpu-{len(self.threads)}",
                    daemon=True,
                )
                self.threads.append(t)
                t.start()

    def resize(self, width: int) -> int:
        w = max(1, min(int(width), self.hard_cap))
        self.gate.set_limit(w)
        self._ensure_threads(w)
        return w

    def _run(self) -> None:
        while not self.stop.is_set():
            if not self.active:
                time.sleep(0.05)
                continue
            if not self.gate.acquire(timeout=0.1):
                continue
            try:
                try:
                    s: _Sample = self.decode_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                self._process(s)
            finally:
                self.gate.release()

    def _process(self, s: _Sample) -> None:
        try:
            raw, s.raw = s.raw, None
            with self.tracer.span(STAGE_DECODE, index=s.index,
                                  batch_id=s.batch_id):
                decoded = self.dataset.decode_raw(raw, s.index)
            with self.tracer.span(STAGE_AUGMENT, index=s.index,
                                  batch_id=s.batch_id):
                item = self.dataset.augment_item(decoded, s.index)
            self.done_q.put((s, item))
        except BaseException as e:  # routed to the consumer, which re-raises
            self.done_q.put((s, _Failure(e)))

    def join(self, timeout: float = 2.0) -> None:
        for t in self.threads:
            t.join(timeout=timeout)


# ---------------------------------------------------------------------------
# process-backed CPU stage (the GIL escape)
# ---------------------------------------------------------------------------

# attempts per sample across worker crashes: a dead worker fails only its
# in-flight sample, and only after this many fresh workers also died on it
PROC_TASK_ATTEMPTS = 3

# tasks in flight per worker: one EXECUTING plus one QUEUED in its pipe, so
# the parent's round trip between samples is hidden
PROC_PREFILL_DEPTH = 2

# workers spawned by one ensure() call at most: a resize from 4 to 32 grows
# the pool over a few pump passes instead of starting 28 interpreters, each
# importing numpy, at once on the host's cores
PROC_SPAWN_STEP = 4


def _cpu_proc_main(payload: bytes, conn, shm_spec=None) -> None:
    """Spawn entry point for one CPU worker process.

    Runs ONLY ``decode_raw`` + ``augment_item`` on tasks received over the
    pipe; storage IO, assembly and tracing stay in the parent.  Stage
    endpoints are measured here with ``time.monotonic`` (system-wide
    CLOCK_MONOTONIC) and shipped home so the parent records real per-worker
    spans.  A ``bind`` message replaces the dataset wholesale: how the
    parent pushes per-epoch state into a pool that outlives iterators.  The
    worker never imports torch and never touches a card.

    A reader thread takes each message off the pipe as it arrives.  The
    parent's pump sends a task while it is not reading results, so a worker
    that read only between samples could sit blocked on a result the full
    pipe will not take while the pump sits blocked on a task the worker's
    full pipe will not take: a deadlock once a sample outgrows the socket
    buffer (about 200 KB).  The reference's worker reads between samples.
    With the reader, the pump's sends always drain; the inbox holds at most
    ``PROC_PREFILL_DEPTH`` tasks, the rebinds and the slab messages.

    ``shm_spec`` = ``(name, slot_bytes, slots)`` attaches the zero-copy
    transport (``PipelineConfig.transport="shm"``): finished samples are
    packed into the parent-owned slab and shipped as ``done_shm`` handles;
    ``free`` returns slots the parent consumed, ``slab_reset`` reclaims
    everything at an epoch takeover, ``slab_cap`` is the autotuner's live
    pressure knob.  Anything that cannot pack falls back to the pickle
    ``done`` with the reason attached.  The slab's writer is
    single-threaded, so this loop applies those three messages from the
    inbox, never the reader thread.  ``die`` is the test-only crash
    injection hook (:meth:`_CPUProcessPool.inject_crash`)."""
    try:
        dataset = pickle.loads(payload)
    except Exception as e:  # exotic: the parent pre-validated pickling
        try:
            conn.send(("crash", f"worker could not unpickle dataset: {e!r}"))
        except OSError:
            pass
        conn.close()
        return
    writer = None
    if shm_spec is not None:
        try:
            writer = shm_mod.SlabWriter(*shm_spec)
        except Exception as e:
            # the segment vanished (the parent raced shutdown): degrade to
            # the pipe
            try:
                conn.send(("crash", f"worker could not attach slab: {e!r}"))
            except OSError:
                pass
            writer = None
    inbox: "queue.Queue" = queue.Queue()

    def read() -> None:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                msg = ("stop",)
            inbox.put(msg)
            if msg[0] == "stop":
                return

    threading.Thread(target=read, name="cpu-proc-reader", daemon=True).start()
    die_on_task: Optional[str] = None
    while True:
        msg = inbox.get()
        tag = msg[0]
        if tag == "stop":
            break
        if tag == "bind":
            try:
                dataset = pickle.loads(msg[1])
            except Exception as e:
                try:
                    conn.send(("crash", f"worker could not rebind dataset: {e!r}"))
                except OSError:
                    pass
                break
            continue
        if tag == "free":
            if writer is not None:
                writer.free_slots(msg[1])
            continue
        if tag == "slab_reset":
            if writer is not None:
                writer.reset()
            continue
        if tag == "slab_cap":
            if writer is not None:
                writer.set_cap(msg[1])
            continue
        if tag == "die":
            # crash injection: "now" dies at once; "mid_slab_write" dies on
            # the NEXT task with a slot claimed and half-written, so the
            # handle is never sent and the parent must reclaim the slot by
            # retiring the slab and retry the sample elsewhere
            if msg[1] == "mid_slab_write" and writer is not None:
                die_on_task = msg[1]
                continue
            os._exit(1)
        _, sid, index, raw = msg
        try:
            t0 = time.monotonic()
            decoded = dataset.decode_raw(raw, index)
            t1 = time.monotonic()
            item = dataset.augment_item(decoded, index)
            t2 = time.monotonic()
            if die_on_task == "mid_slab_write":
                slot = writer._take_slot()
                if slot is not None:
                    writer.shm.buf[slot * writer.slot_bytes] = 0xAB
                os._exit(1)
            why = None
            if writer is not None:
                handle, why = writer.try_pack(item)
                if handle is not None:
                    conn.send(("done_shm", sid, handle, (t0, t1, t2)))
                    continue
            conn.send(("done", sid, item, (t0, t1, t2), why))
        except Exception as e:
            try:
                pickle.dumps(e)
                exc: BaseException = e
            except Exception:
                exc = RuntimeError(f"cpu worker failed on sample {index}: {e!r}")
            try:
                conn.send(("err", sid, exc))
            except OSError:
                break
    if writer is not None:
        writer.close()
    conn.close()


class _ProcWorker:
    """Parent-side handle: process + duplex pipe + in-flight task ids (FIFO:
    the child answers in send order).  ``send_lock`` serializes writes: at
    an epoch takeover the outgoing pump can still be mid-``send`` when
    ``attach`` broadcasts the rebind."""

    __slots__ = ("proc", "conn", "sids", "send_lock", "slab")

    def __init__(self, proc, conn, slab=None) -> None:
        self.proc = proc
        self.conn = conn
        self.sids: List[int] = []  # at most PROC_PREFILL_DEPTH entries
        self.send_lock = threading.Lock()
        self.slab: Optional[shm_mod.ParentSlab] = slab  # shm transport only

    def send(self, msg: Tuple) -> None:
        with self.send_lock:
            self.conn.send(msg)


def _finalize_pool(slabs: List["shm_mod.ParentSlab"],
                   shutdown: threading.Event) -> None:
    """weakref.finalize target for :class:`_CPUProcessPool` (must not hold
    the pool itself): bar further spawns, then unlink every slab."""
    shutdown.set()
    shm_mod.close_slabs(slabs)


class _CPUProcessPool:
    """Spawn-based decode+augment worker pool, owned by the LOADER.

    Spawning a worker costs hundreds of milliseconds (fresh interpreter +
    numpy import), so the pool PERSISTS across epochs: each epoch's
    :class:`_ProcCPUStage` attaches to it, re-``bind``s the freshly pickled
    dataset, and detaches at shutdown without killing workers.  ``owner``
    is the takeover token: an abandoned iterator's pump thread notices it
    lost ownership and exits.  Task ids are pool-global and monotonic, so
    results from an abandoned epoch's tasks are recognized and dropped.
    ``spawn``, never ``fork``: the parent runs threads and may hold a CUDA
    context.  Workers are daemon processes; the loader's ``close`` ends
    them.

    With the shm transport (``shm_spec`` = ``(slot_bytes, slots)``) the pool
    creates, and so owns, one slab a worker; ``_slabs`` is a live list
    shared with the exit finalizer, so segments made for respawned workers
    are unlinked even if the pool is never closed.  The finalizer runs
    before multiprocessing's own atexit ends the daemon workers, so a pump
    could reap those and respawn after the slabs were unlinked; the shared
    ``_shutdown`` flag bars ``ensure`` from spawning once it is set."""

    def __init__(self, payload: bytes, hard_cap: int,
                 shm_spec: Optional[Tuple[int, int]] = None) -> None:
        self.ctx = multiprocessing.get_context("spawn")
        self.payload = payload
        self.hard_cap = max(1, hard_cap)
        self.workers: List[_ProcWorker] = []
        self.owner: Optional[Any] = None
        self.crashes = 0  # workers that died unexpectedly
        self.respawns = 0
        # last child-reported diagnostic ("crash" message)
        self.last_error: Optional[str] = None
        self._sid = 0
        self._lock = threading.Lock()
        self._closed = False
        self.shm_spec = shm_spec
        self.slab_cap: Optional[int] = None  # live usable-slot bound
        self._slabs: List[shm_mod.ParentSlab] = []
        self._shutdown = threading.Event()
        self._finalizer = weakref.finalize(
            self, _finalize_pool, self._slabs, self._shutdown)

    def next_sid(self) -> int:
        with self._lock:
            self._sid += 1
            return self._sid

    def attach(self, stage: Any, payload: bytes) -> None:
        with self._lock:
            self.owner = stage
            rebind = payload != self.payload
            self.payload = payload
        if rebind:
            for w in list(self.workers):  # snapshot: an old pump may mutate
                try:
                    w.send(("bind", payload))
                except OSError:
                    pass  # dead worker; the pump's reap pass replaces it

    def spawn_one(self) -> None:
        parent_conn, child_conn = self.ctx.Pipe()
        slab = None
        worker_spec = None
        if self.shm_spec is not None:
            slab = shm_mod.ParentSlab(*self.shm_spec)
            self._slabs.append(slab)
            worker_spec = slab.spec()
        proc = self.ctx.Process(
            target=_cpu_proc_main,
            args=(self.payload, child_conn, worker_spec),
            name=f"pipe-cpu-proc-{len(self.workers)}",
            daemon=True,
        )
        proc.start()
        child_conn.close()  # the child holds its own copy
        w = _ProcWorker(proc, parent_conn, slab)
        if slab is not None and self.slab_cap is not None:
            # respawned workers honour the tuned slab-pressure cap too
            try:
                w.send(("slab_cap", self.slab_cap))
            except OSError:  # pragma: no cover - died at birth; reap handles it
                pass
        self.workers.append(w)

    def ensure(self, n: int) -> None:
        """Grow toward ``n`` workers (at most ``hard_cap``), by at most
        :data:`PROC_SPAWN_STEP` a call; the owning stage's pump calls this
        every pass.  Never shrinks: a narrower stage leaves the surplus
        workers idle behind its gate."""
        # under the lock: at an epoch takeover the outgoing and incoming
        # pumps briefly coexist, and unsynchronized growth could overshoot
        with self._lock:
            if self._closed or self._shutdown.is_set():
                return
            want = min(max(n, 1), self.hard_cap, len(self.workers) + PROC_SPAWN_STEP)
            while len(self.workers) < want:
                self.spawn_one()

    def raise_cap(self, hard_cap: int) -> None:
        with self._lock:
            self.hard_cap = max(self.hard_cap, hard_cap)

    def remove(self, w: _ProcWorker) -> None:
        with self._lock:
            if w in self.workers:
                self.workers.remove(w)
        if w.slab is not None:
            # views already delivered stay valid (the parent owns the
            # mapping); the name is dropped now so nothing outlives the pool
            w.slab.retire()

    def reset_slabs(self) -> None:
        """Epoch takeover: every slot is reclaimed wholesale (a previous
        iterator may have been abandoned with handles it never released)."""
        for w in list(self.workers):
            if w.slab is None:
                continue
            w.slab.reset_accounting()
            try:
                w.send(("slab_reset",))
            except OSError:
                pass  # dead worker; the pump's reap pass replaces it

    def set_slab_cap(self, cap: int) -> None:
        """The autotuner's live slab-pressure knob: bound how many slots each
        worker may use (lower = earlier pickle fallback, less memory hot)."""
        self.slab_cap = cap
        for w in list(self.workers):
            if w.slab is None:
                continue
            try:
                w.send(("slab_cap", cap))
            except OSError:
                pass

    def inject_crash(self, mode: str = "now", worker: int = 0) -> None:
        """TEST HOOK: make worker ``worker`` die: ``"now"`` at once,
        ``"mid_slab_write"`` on the first task sent after this message, with
        a slot claimed and half-written (crash-safe slot reclamation)."""
        with self._lock:
            if not self.workers:
                raise RuntimeError("no workers to crash")
            w = self.workers[worker % len(self.workers)]
        w.send(("die", mode))

    def close(self) -> None:
        """Terminate every worker (the loader's ``close``) and unlink every
        slab."""
        with self._lock:
            self._closed = True
            workers, self.workers = list(self.workers), []
        for w in workers:
            try:
                w.send(("stop",))
            except OSError:
                pass
            w.conn.close()
        for w in workers:
            w.proc.join(timeout=0.5)
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=2.0)
        shm_mod.close_slabs(self._slabs)
        self._slabs.clear()


class _ProcCPUStage:
    """decode + augment in the spawn-process pool: same contract as
    :class:`_CPUStage` (pull from ``decode_q``, deliver to ``done_q``,
    gate-bounded parallelism, live resize, ``active`` pause flag) with the
    work outside the GIL.

    One parent-side pump thread claims samples from the fetch->decode queue
    under the gate (a permit is held from claim to final resolution),
    assigns up to :data:`PROC_PREFILL_DEPTH` tasks per worker over its pipe,
    multiplexes completions with ``multiprocessing.connection.wait``, and
    records the shipped decode/augment spans under the worker's pid.
    Crash handling: a dead worker's in-flight samples are requeued ahead of
    fresh work and retried on another worker up to ``PROC_TASK_ATTEMPTS``
    attempts (raw bytes are kept parent-side, so a retry never refetches),
    the corpse is reaped and a replacement spawned.  With the shm transport
    the pump also flushes the slots collate released back to their workers
    (``free`` messages), and a dead worker's slab is retired with it."""

    def __init__(
        self,
        payload: bytes,
        *,
        pool: _CPUProcessPool,
        width: int,
        hard_cap: int,
        decode_q: _BoundedQ,
        done_q: "queue.Queue",
        stop: threading.Event,
        tracer,
    ) -> None:
        self.pool = pool
        self.decode_q = decode_q
        self.done_q = done_q
        self.stop = stop
        self.tracer = tracer
        self.hard_cap = max(width, hard_cap)
        self._width = max(1, width)
        # the gate bounds claimed-but-unresolved samples: PREFILL_DEPTH per
        # worker, so every worker can hold a queued spare
        self.gate = AdjustableSemaphore(PROC_PREFILL_DEPTH * self._width)
        self.active = True
        self.requeued = 0  # samples retried after a worker crash
        # transport accounting (stage_stats()["transport"]): a pipe sample
        # costs serialize + deserialize (2x payload), an shm sample the
        # worker's single slab write
        self.shm_samples = 0
        self.pipe_samples = 0
        self.fallbacks: Dict[str, int] = {}
        self.bytes_copied = 0
        self._inflight: Dict[int, _Sample] = {}
        self._attempts: Dict[int, int] = {}
        self._pending: Deque[int] = deque()  # crash-requeued sids, FIFO
        # no spawn here: the caller may be the consumer's thread (an
        # executor flip mid-epoch), so the pump grows the pool from its
        # first pass on
        pool.attach(self, payload)
        if pool.shm_spec is not None:
            pool.reset_slabs()
        self._thread = threading.Thread(
            target=self._run, name="pipe-cpu-pool-pump", daemon=True
        )
        self._thread.start()

    @property
    def width(self) -> int:
        return self._width

    def resize(self, width: int) -> int:
        """Set the stage's parallelism; the pump grows the pool toward it
        (never on the caller's thread, which is the consumer's)."""
        w = max(1, min(int(width), self.hard_cap))
        self._width = w
        self.gate.set_limit(PROC_PREFILL_DEPTH * w)
        return w

    # -- pump ---------------------------------------------------------------
    def _owned(self) -> bool:
        return self.pool.owner is self and not self.stop.is_set()

    def _run(self) -> None:
        while self._owned():
            if self.pool._closed:
                # the loader's close() ended the workers mid-epoch: fail the
                # epoch rather than wait on workers that will not come
                self.done_q.put((None, _Failure(RuntimeError(
                    "the CPU process pool was closed while the epoch ran"))))
                return
            self._reap()
            self.pool.ensure(self._width)
            self._flush_frees()
            self._dispatch()
            workers = list(self.pool.workers)
            busy = [w.conn for w in workers if w.sids]
            if busy:
                for conn in _mp_wait(busy, timeout=0.05):
                    w = next((x for x in workers if x.conn is conn), None)
                    if w is None:
                        continue
                    try:
                        self._resolve(w, w.conn.recv())
                    except (EOFError, OSError):
                        pass  # worker died mid-send; the next reap handles it

    def _flush_frees(self) -> None:
        """Return consumed slots to their workers (shm transport): collate
        queued them through ``ShmItem.release``; sending them on the command
        pipe here keeps the consumer's release path lock-only."""
        for w in list(self.pool.workers):
            if w.slab is None:
                continue
            pairs = w.slab.drain_freed()
            if not pairs:
                continue
            try:
                w.send(("free", pairs))
            except OSError:
                pass  # dead worker; its slab is retired by the reap pass

    def _dispatch(self) -> None:
        while self._owned():
            # emptiest eligible worker first: fill every idle worker before
            # granting anyone its prefill spare
            candidates = [x for x in list(self.pool.workers)
                          if len(x.sids) < PROC_PREFILL_DEPTH
                          and x.proc.is_alive()]
            if not candidates:
                return
            w = min(candidates, key=lambda x: len(x.sids))
            if self._pending:
                sid = self._pending.popleft()  # a retry holds its permit already
            elif self.active and self.gate.acquire(timeout=0):
                any_busy = any(x.sids for x in self.pool.workers)
                try:
                    # bounded blocking get when the whole stage is idle: the
                    # pump's only sleep, released the instant a fetch lands
                    s = self.decode_q.get(timeout=0.0 if any_busy else 0.05)
                except queue.Empty:
                    self.gate.release()
                    return
                sid = self.pool.next_sid()
                self._inflight[sid] = s
                self._attempts[sid] = 1
            else:
                if not self.active and not self._pending:
                    time.sleep(0.02)  # paused: don't spin on the gate
                return
            s = self._inflight[sid]
            w.sids.append(sid)
            try:
                w.send(("task", sid, s.index, s.raw))
            except OSError:
                w.sids.remove(sid)  # broken pipe = dead worker; reap + retry
                self._retry_or_fail(sid, RuntimeError(
                    f"cpu worker pid={w.proc.pid} lost sample {s.index} (pipe closed)"))

    def _reap(self) -> None:
        dead = [w for w in list(self.pool.workers) if not w.proc.is_alive()]
        for w in dead:
            try:
                while w.conn.poll():  # a result may have beaten the crash
                    self._resolve(w, w.conn.recv())
            except (EOFError, OSError):
                pass
            self.pool.crashes += 1
            why = (f"; last worker diagnostic: {self.pool.last_error}"
                   if self.pool.last_error else "")
            for sid in w.sids:  # executing task + any prefilled spare
                self._retry_or_fail(sid, RuntimeError(
                    f"cpu worker pid={w.proc.pid} died "
                    f"(exitcode={w.proc.exitcode}) while decoding{why}"))
            w.sids.clear()
            w.conn.close()
            self.pool.remove(w)
            self.pool.respawns += 1

    def _retry_or_fail(self, sid: int, exc: BaseException) -> None:
        s = self._inflight.get(sid)
        if s is None:
            return  # an abandoned epoch's task: nothing to deliver to
        if self._attempts.get(sid, 1) < PROC_TASK_ATTEMPTS:
            self._attempts[sid] = self._attempts.get(sid, 1) + 1
            self.requeued += 1
            self._pending.append(sid)
            return
        del self._inflight[sid]
        self._attempts.pop(sid, None)
        self.done_q.put((s, _Failure(exc)))
        self.gate.release()

    def _resolve(self, w: _ProcWorker, msg: Tuple) -> None:
        tag = msg[0]
        if tag == "crash":
            # the worker is about to exit; reap accounts for it and retries
            # its tasks.  Keep the child's diagnostic.
            self.pool.last_error = msg[1]
            return
        sid = msg[1]
        if sid in w.sids:
            w.sids.remove(sid)
        s = self._inflight.pop(sid, None)
        self._attempts.pop(sid, None)
        if s is None:
            return  # stale result from an abandoned epoch's stage
        if tag == "done_shm":
            _, _, handle, (t0, t1, t2) = msg
            item: Any = w.slab.view_item(handle)
            # the worker's slab write is the transport's only copy
            nbytes = handle[2]
            self.shm_samples += 1
            self.bytes_copied += nbytes
            self.tracer.count(BYTES_COPIED, nbytes)
            self._record_proc_spans(w, s, t0, t1, t2)
            s.raw = None
            self.done_q.put((s, item))
        elif tag == "done":
            _, _, item, (t0, t1, t2), why = msg
            # pickle transport (or an shm sample's fallback, with its
            # reason): one serialize in the worker, one deserialize here,
            # two full passes over the payload
            nbytes = shm_mod.item_nbytes(item) if isinstance(item, dict) else 0
            self.pipe_samples += 1
            self.bytes_copied += 2 * nbytes
            self.tracer.count(BYTES_COPIED, 2 * nbytes)
            if why is not None:
                self.fallbacks[why] = self.fallbacks.get(why, 0) + 1
            self._record_proc_spans(w, s, t0, t1, t2)
            s.raw = None
            self.done_q.put((s, item))
        else:  # "err": a dataset exception, not a crash — no retry
            self.done_q.put((s, _Failure(msg[2])))
        self.gate.release()

    def _record_proc_spans(self, w: _ProcWorker, s: _Sample,
                           t0: float, t1: float, t2: float) -> None:
        pid = w.proc.pid
        self.tracer.record(STAGE_DECODE, t0, t1, tid=pid,
                           index=s.index, batch_id=s.batch_id, proc=True)
        self.tracer.record(STAGE_AUGMENT, t1, t2, tid=pid,
                           index=s.index, batch_id=s.batch_id, proc=True)

    def join(self, timeout: float = 2.0) -> None:
        self._thread.join(timeout=timeout)


# ---------------------------------------------------------------------------
# assembler / iterator
# ---------------------------------------------------------------------------


class _Group:
    """Window-mode assembly state for up to ``reorder_window`` consecutive
    batches: the group's batch slots are emitted in batch order, each filled
    with the first ``size`` of the group's samples to complete."""

    __slots__ = ("start_bid", "sizes", "buffer", "indices", "emitted", "closed")

    def __init__(self, start_bid: int) -> None:
        self.start_bid = start_bid  # first dispatched batch_id of the group
        self.sizes: List[int] = []  # batch sizes, in dispatched batch order
        self.buffer: List[Any] = []  # completed items, in completion order
        self.indices: List[int] = []  # dataset indices, completion order
        self.emitted = 0  # batch slots already emitted
        self.closed = False  # a later group was opened: no more batches


class _ShuffleMeter:
    """Windowed shuffle-quality estimator over the delivered index stream.

    Window-mode reassembly fills batches with whichever samples complete
    first, and completion time can correlate with content, so shuffle
    quality is measured on what the model sees.  Two normalized [0, 1]
    numbers: ``within_batch`` (mean normalized entropy of each batch's index
    histogram over ``buckets`` equal dataset strata) and ``across_batch``
    (count-weighted mean, over strata, of the entropy of that stratum's
    spread across the last ``window_batches`` batches).  One
    :data:`SHUFFLE_ENTROPY` span is recorded per measurement window."""

    def __init__(self, dataset_len: int, tracer, *, buckets: int = 16,
                 window_batches: int = 32) -> None:
        self.n = max(1, int(dataset_len))
        self.buckets = max(2, min(buckets, self.n))
        self.window_batches = max(2, window_batches)
        self.tracer = tracer
        self._hists: Deque[np.ndarray] = deque(maxlen=self.window_batches)
        self._within: Deque[float] = deque(maxlen=self.window_batches)
        self.batches = 0
        self._win_t0: Optional[float] = None

    def note_batch(self, indices) -> None:
        if indices is None or len(indices) == 0:
            return
        now = time.monotonic()
        if self._win_t0 is None:
            self._win_t0 = now
        idx = np.asarray(indices, dtype=np.int64)
        strata = np.minimum(idx * self.buckets // self.n, self.buckets - 1)
        hist = np.bincount(strata, minlength=self.buckets).astype(np.float64)
        p = hist / hist.sum()
        nz = p[p > 0.0]
        hmax = math.log(min(len(idx), self.buckets))
        within = float(-(nz * np.log(nz)).sum() / hmax) if hmax > 0 else 1.0
        self._within.append(within)
        self._hists.append(hist)
        self.batches += 1
        if self.batches % self.window_batches == 0:
            snap = self.snapshot()
            self.tracer.record(
                SHUFFLE_ENTROPY, self._win_t0, now,
                within=snap["within_batch"], across=snap["across_batch"],
                batches=self.batches,
            )
            self._win_t0 = None

    def snapshot(self) -> Dict[str, Any]:
        if not self._within:
            return {"within_batch": None, "across_batch": None, "batches": 0}
        within = float(np.mean(self._within))
        across = None
        if len(self._hists) >= 2:
            m = np.stack(self._hists)  # (batches, strata)
            totals = m.sum(axis=0)  # per-stratum sample counts
            hmax = math.log(m.shape[0])
            acc = 0.0
            for k in range(m.shape[1]):
                if totals[k] <= 0:
                    continue
                q = m[:, k] / totals[k]
                nz = q[q > 0.0]
                acc += float(totals[k]) * float(-(nz * np.log(nz)).sum() / hmax)
            across = acc / float(totals.sum())
        return {
            "within_batch": round(within, 4),
            "across_batch": round(across, 4) if across is not None else None,
            "batches": self.batches,
        }


class _PipelineIter:
    """Iterator over a :class:`~repro_torch.core.loader.ConcurrentDataLoader`
    in pipeline mode: the legacy iterator's external contract (ordered or
    windowed delivery, epoch accounting, resume cursor, shutdown)."""

    def __init__(self, loader) -> None:
        self.loader = loader
        cfg = loader.cfg
        self.cfg = cfg
        self.tracer = loader.tracer
        dataset = loader.dataset
        pipe = cfg.pipeline
        self.split = bool(dataset.supports_split())
        self.strict = pipe.reorder == "strict"
        self.window = 1 if self.strict else max(1, pipe.reorder_window)

        at = cfg.autotune
        # stage sizing: 0 derives io_workers from the legacy loader's total
        # fetch-thread count so pipeline-vs-legacy runs at equal concurrency
        io_workers = pipe.io_workers or max(1, cfg.num_workers * cfg.num_fetch_workers)
        cpu_workers = pipe.cpu_workers or 4
        queue_depth = max(1, pipe.stage_queue_depth)
        self.max_outstanding = max(1, cfg.num_workers * cfg.prefetch_factor)
        # knob ceilings widen over the static config (enabling autotune must
        # never cap the loader below its autotune=off operating point)
        self._max_io_bound = max(at.max_fetch_workers, io_workers)
        self._max_cpu_bound = max(at.max_cpu_workers, cpu_workers)
        self._max_queue_bound = max(at.max_stage_queue, queue_depth)
        self._max_outstanding_bound = max(at.max_outstanding, self.max_outstanding)
        if at.enabled:
            # resume from values the controller already learned (prev epoch)
            tuned = loader._tuned
            if not self.strict:
                self.window = min(
                    max(tuned.get("reorder_window", self.window),
                        at.min_reorder_window),
                    max(at.max_reorder_window, self.window),
                )
            io_workers = min(
                max(tuned.get("io_workers", io_workers), at.min_fetch_workers),
                self._max_io_bound,
            )
            cpu_workers = min(
                max(tuned.get("cpu_workers", cpu_workers), at.min_cpu_workers),
                self._max_cpu_bound,
            )
            queue_depth = min(
                max(tuned.get("stage_queue", queue_depth), at.min_stage_queue),
                self._max_queue_bound,
            )
            self.max_outstanding = min(
                max(tuned.get("outstanding", self.max_outstanding),
                    at.min_outstanding),
                self._max_outstanding_bound,
            )

        # budget co-tuning (AutotuneConfig.thread_budget): io and cpu widths
        # are one coupled knob under a fixed total; the split value is the IO
        # width and the CPU stage always gets the remainder
        self._budget = (
            at.thread_budget
            if at.enabled and at.thread_budget > 0 and self.split
            else 0
        )
        if at.enabled and at.thread_budget > 0 and not self.split:
            # monolithic fallback: no CPU stage to trade against, but the
            # budget still caps the total width
            self._max_io_bound = min(self._max_io_bound, at.thread_budget)
            io_workers = min(io_workers, at.thread_budget)
        self._split_lo = self._split_hi = 0
        if self._budget:
            b = self._budget
            self._split_lo = max(at.min_fetch_workers, b - self._max_cpu_bound, 1)
            # the IO stage's hard cap bounds the split too: a split above it
            # (the reference allows one) runs IO at the cap and leaves
            # threads of the budget unused
            self._split_hi = max(self._split_lo, min(b - max(at.min_cpu_workers, 1),
                                                     self._max_io_bound))
            seed = io_workers
            if pipe.io_workers == 0 and "io_cpu_split" not in loader._tuned:
                # cores-aware seed: the CPU stage is compute-bound, so start
                # it at the cores this process may use and give IO the rest
                seed = b - available_cpu_count()
            io_workers = min(
                max(loader._tuned.get("io_cpu_split", seed), self._split_lo),
                self._split_hi,
            )
            cpu_workers = b - io_workers

        # CPU executor kind: static config, overridden by the tuned value
        # when the budget co-tuner flipped it in a previous epoch
        self.cpu_kind = pipe.cpu_executor if self.split else "thread"
        if at.enabled and self.split and "cpu_executor" in loader._tuned:
            self.cpu_kind = "process" if loader._tuned["cpu_executor"] else "thread"
        # the process stage ships a pickled dataset copy to each spawned
        # worker.  Pickle once, up front: a clear construction-time error
        # beats an opaque one from inside a worker.
        self._proc_payload: Optional[bytes] = None
        if self.split and (
            self.cpu_kind == "process" or (self._budget and at.tune_cpu_executor)
        ):
            try:
                self._proc_payload = pickle.dumps(dataset)
            except Exception as e:
                if self.cpu_kind == "process":
                    raise ValueError(
                        "cpu_executor='process' requires a picklable dataset "
                        "(the process CPU stage ships a pickled copy to each "
                        "spawned worker; drop store/tracer members on pickle — "
                        "see MapDataset's picklability contract): "
                        f"pickling failed with {e!r}"
                    ) from e
                self._proc_payload = None  # the executor-kind knob is just absent

        # process-stage result transport: the zero-copy slab ring means
        # something only where a process stage can exist (split + picklable);
        # everything else keeps the pickle pipe (and the thread stage has no
        # transport: its items never leave the process)
        self.transport = "pipe"
        self._shm_spec: Optional[Tuple[int, int]] = None
        if pipe.transport == "shm" and self._proc_payload is not None:
            self.transport = "shm"
            self._shm_spec = (pipe.slab_slot_bytes, pipe.slab_slots)
        # slab-pressure knob state (usable-slot cap <= allocated slots)
        self._slab_cap = self._shm_spec[1] if self._shm_spec else 0
        if at.enabled and self._shm_spec and "slab_slots" in loader._tuned:
            self._slab_cap = min(
                max(loader._tuned["slab_slots"], at.min_slab_slots),
                self._shm_spec[1],
            )

        self._stop = threading.Event()
        self.decode_q = _BoundedQ(queue_depth, self._stop)
        self.done_q: "queue.Queue" = queue.Queue()
        # pinned host staging: only for the default collate (a custom
        # collate_fn owns its own batch layout)
        staging_n = pipe.staging_buffers if loader.collate_fn is collate else 0
        # sharded delivery: lane threads collate and copy each mesh slice of
        # a batch to the card and push the composed batch back into done_q as
        # a (_Composed, batch) token; each lane has its own staging pool
        self._assembler = None
        if loader.delivery_plan is not None:
            from repro_torch.core.delivery import ShardedAssembler

            self._assembler = ShardedAssembler(
                loader.delivery_plan, loader.collate_fn, done_q=self.done_q,
                stop=self._stop, tracer=self.tracer, staging_buffers=staging_n,
            )
        self._staging = None
        if staging_n > 0 and self._assembler is None:
            self._staging = HostBatchPool(depth=staging_n)
        self.io = _IOStage(
            dataset,
            mode="asyncio" if cfg.impl == "asyncio" else "threaded",
            width=io_workers,
            hard_cap=self._max_io_bound if at.enabled else io_workers,
            split=self.split,
            decode_q=self.decode_q,
            done_q=self.done_q,
            tracer=self.tracer,
            hedge=loader.hedge,
        )
        cpu_hard = self._max_cpu_bound if at.enabled else cpu_workers
        if not self.split:
            # monolithic fallback: the fetch stage produces finished items,
            # so no CPU stage (thread or process) is spun up for nothing
            cpu_workers = cpu_hard = 1
        self._cpu_hard = cpu_hard
        self._cpu_width = cpu_workers
        # both CPU stage kinds share decode_q/done_q and are created lazily;
        # the inactive one (if ever created) is paused, so the cpu_executor
        # knob can swap kinds mid-epoch without disturbing in-flight samples
        self._thread_cpu: Optional[_CPUStage] = None
        self._proc_cpu: Optional[_ProcCPUStage] = None
        self.cpu: Any = self._make_cpu_stage(self.cpu_kind)

        self._sampler_iter = iter(loader.sampler)
        self._exhausted = False
        self._shutdown = False
        self._lock = threading.Lock()
        self._dispatched_samples = 0
        self._completed_samples = 0
        self._dispatched_batches = 0
        self._emitted_batches = 0
        self._bid_base = 0  # first dispatched batch_id (resume offsets it)
        # samples per batch, learned from the first dispatched task: host-
        # sharded batches hold batch_size/num_hosts indices
        self._per_batch: Optional[int] = None
        # strict-mode assembly: per-batch positional slots + ready buffer
        self._slots: Dict[int, List[Any]] = {}
        self._remaining: Dict[int, int] = {}
        self._ready: Dict[int, Any] = {}
        self._next_bid: Optional[int] = None
        # window-mode assembly: per-group first-N-ready composition, keyed
        # by dispatch-order group sequence number
        self._groups: Dict[int, _Group] = {}
        self._cur_group = 0  # next group to deliver
        self._next_gid = 0  # next group to open
        self._gid_of_bid: Dict[int, int] = {}
        self._group_consumed = 0  # absolute bid past the last emitted group
        self._shuffle = _ShuffleMeter(loader.sampler.dataset_len, self.tracer)
        # strict batch composition equals the sampler's dispatch
        self._batch_indices: Dict[int, Tuple[int, ...]] = {}
        if loader.autotuner is not None:
            self._bind_knobs(loader.autotuner, at)
        self._pump()

    def _bind_knobs(self, auto, at) -> None:
        """Hand this epoch's control surfaces to the loader's autotuner.  The
        callbacks reach this iterator through a weakref: the autotuner
        outlives every epoch's iterator, and a strong closure would pin an
        abandoned one (and its stage threads) until the next bind()."""
        _wget, _wset = make_weak_knob_callbacks(self)
        extra_kw: Dict[str, Any] = {}
        if self._shm_spec is not None:
            # the slab-pressure knob exists only while the shm transport is
            # live (the slab allocation caps how far it may rise)
            extra_kw.update(
                get_slab=_wget(lambda it: it._slab_cap),
                set_slab=_wset(lambda it, n: it._set_slab_slots(n)),
                max_slab=self._shm_spec[1],
            )
        if not self.strict and self._assembler is None:
            # the reorder-window knob exists only where the window does
            # (sharded delivery requires strict reorder)
            extra_kw.update(
                get_reorder=_wget(lambda it: it.window),
                set_reorder=_wset(lambda it, n: it._set_reorder_window(n)),
            )
        if self._budget:
            # one coupled io/cpu split knob (+ the executor kind when the
            # dataset is process-capable) instead of two width knobs
            proc_ok = self._proc_payload is not None
            knobs = build_budget_knobs(
                at,
                budget=self._budget,
                lo_split=self._split_lo,
                hi_split=self._split_hi,
                get_split=_wget(lambda it: it.io.gate.limit),
                set_split=_wset(lambda it, n: it._set_split(n)),
                get_outstanding=_wget(lambda it: it.max_outstanding),
                set_outstanding=_wset(lambda it, n: it._set_outstanding(n)),
                get_queue=_wget(lambda it: it.decode_q.depth),
                set_queue=_wset(lambda it, n: it._set_stage_queue(n)),
                get_cpu_executor=(
                    _wget(lambda it: int(it.cpu_kind == "process")) if proc_ok else None
                ),
                set_cpu_executor=(
                    _wset(lambda it, n: it._set_cpu_executor(n)) if proc_ok else None
                ),
                hedge=self.loader.hedge,
                max_outstanding=self._max_outstanding_bound,
                max_queue=self._max_queue_bound,
                **extra_kw,
            )
        else:
            knobs = build_pipeline_knobs(
                at,
                get_io=_wget(lambda it: it.io.gate.limit),
                set_io=_wset(lambda it, n: it._set_io_workers(n)),
                get_cpu=_wget(lambda it: it.cpu.width),
                set_cpu=_wset(lambda it, n: it._set_cpu_workers(n)),
                get_outstanding=_wget(lambda it: it.max_outstanding),
                set_outstanding=_wset(lambda it, n: it._set_outstanding(n)),
                get_queue=_wget(lambda it: it.decode_q.depth),
                set_queue=_wset(lambda it, n: it._set_stage_queue(n)),
                hedge=self.loader.hedge,
                max_io=self._max_io_bound,
                max_cpu=self._max_cpu_bound,
                max_outstanding=self._max_outstanding_bound,
                max_queue=self._max_queue_bound,
                **extra_kw,
            )
            if not self.split:
                # nothing flows through the CPU stage or its queue: inert
                # knobs would waste the controller's probe windows
                knobs = [k for k in knobs if k.name not in ("cpu_workers", "stage_queue")]
        auto.bind(knobs)
        # the cache knobs (per-batch cadence) ride along every epoch
        for knob in self.loader._cache_knobs:
            auto.attach_knob(knob)

    # -- CPU stage factory / executor swap -----------------------------------
    def _make_cpu_stage(self, kind: str):
        """Create (or reactivate) the CPU stage of the requested kind.  Both
        kinds share decode_q/done_q/stop; the process kind attaches to the
        loader-persistent :class:`_CPUProcessPool` (spawn cost is paid once,
        not per epoch), and rebinding ships this epoch's dataset state."""
        if kind == "process":
            if self._proc_cpu is None:
                pool = self.loader._cpu_pool
                if pool is None or pool._closed or pool.shm_spec != self._shm_spec:
                    if pool is not None:
                        pool.close()  # another transport's slabs: rebuild
                    pool = _CPUProcessPool(self._proc_payload, self._cpu_hard,
                                           shm_spec=self._shm_spec)
                    self.loader._cpu_pool = pool
                else:
                    # a pool from a narrower static epoch: lift its ceiling
                    # instead of closing and respawning it on this thread
                    pool.raise_cap(self._cpu_hard)
                if self._shm_spec and self._slab_cap < self._shm_spec[1]:
                    pool.set_slab_cap(self._slab_cap)
                self._proc_cpu = _ProcCPUStage(
                    self._proc_payload, pool=pool, width=self._cpu_width,
                    hard_cap=self._cpu_hard, decode_q=self.decode_q,
                    done_q=self.done_q, stop=self._stop, tracer=self.tracer,
                )
            else:
                self._proc_cpu.active = True
                self._proc_cpu.resize(self._cpu_width)
            return self._proc_cpu
        if self._thread_cpu is None:
            self._thread_cpu = _CPUStage(
                self.loader.dataset, width=self._cpu_width, hard_cap=self._cpu_hard,
                decode_q=self.decode_q, done_q=self.done_q, stop=self._stop,
                tracer=self.tracer,
            )
        else:
            self._thread_cpu.active = True
            self._thread_cpu.resize(self._cpu_width)
        return self._thread_cpu

    # -- autotuner control surfaces (applied between batches) ----------------
    def _set_io_workers(self, n: int) -> int:
        n = max(self.cfg.autotune.min_fetch_workers, int(n))
        applied = self.io.resize(n)
        self.loader._tuned["io_workers"] = applied
        return applied

    def _resize_cpu(self, n: int) -> int:
        applied = self.cpu.resize(n)
        self._cpu_width = applied
        return applied

    def _set_cpu_workers(self, n: int) -> int:
        n = max(self.cfg.autotune.min_cpu_workers, int(n))
        applied = self._resize_cpu(n)
        self.loader._tuned["cpu_workers"] = applied
        return applied

    def _set_split(self, n: int) -> int:
        """Apply one value of the coupled io/cpu split (budget mode): IO gets
        ``n``, the CPU stage ``budget - n``.  The shrinking side is resized
        first, so the limits never sum above the budget, even transiently
        (surplus in-flight work drains through its gate)."""
        n = max(self._split_lo, min(int(n), self._split_hi))
        cpu = self._budget - n
        if n >= self.io.gate.limit:
            self._resize_cpu(cpu)
            self.io.resize(n)
        else:
            self.io.resize(n)
            self._resize_cpu(cpu)
        self.loader._tuned["io_cpu_split"] = n
        return n

    def _set_cpu_executor(self, v: int) -> int:
        """Swap the CPU stage kind live (binary budget-mode knob).  The old
        stage is paused, not torn down: its in-flight samples finish into
        the shared done_q (strict reorder does not care which executor
        produced a sample), and a revert reactivates it for free."""
        want = "process" if int(v) >= 1 else "thread"
        cur = int(self.cpu_kind == "process")
        if want == self.cpu_kind:
            return cur
        if want == "process" and self._proc_payload is None:
            return cur  # not process-capable: echo so the controller skips
        old = self.cpu
        self.cpu = self._make_cpu_stage(want)
        old.active = False
        self.cpu_kind = want
        applied = int(want == "process")
        self.loader._tuned["cpu_executor"] = applied
        return applied

    def _set_outstanding(self, n: int) -> int:
        at = self.cfg.autotune
        n = max(at.min_outstanding, min(int(n), self._max_outstanding_bound))
        self.max_outstanding = n
        self.loader._tuned["outstanding"] = n
        return n

    def _set_stage_queue(self, n: int) -> int:
        n = max(self.cfg.autotune.min_stage_queue, int(n))
        applied = self.decode_q.resize(n, self._max_queue_bound)
        self.loader._tuned["stage_queue"] = applied
        return applied

    def _set_slab_slots(self, n: int) -> int:
        """Slab-pressure knob (shm transport): cap the usable slots of each
        worker's slab.  The allocation is fixed (``slab_slots``), so the cap
        only gates which slots a worker may hand out: lowering it never
        touches slots in flight, it forces earlier pickle fallback; raising
        it re-admits parked slots on their next free."""
        at = self.cfg.autotune
        hi = self._shm_spec[1] if self._shm_spec else 1
        n = max(at.min_slab_slots, min(int(n), hi))
        self._slab_cap = n
        stage = self._proc_cpu
        if stage is not None:
            stage.pool.set_slab_cap(n)
        self.loader._tuned["slab_slots"] = n
        return n

    def _set_reorder_window(self, n: int) -> int:
        """Reorder-window knob (window mode only): takes effect for the NEXT
        opened group; in-flight groups keep the size they were opened with."""
        if self.strict:
            return 1
        at = self.cfg.autotune
        n = max(at.min_reorder_window, min(int(n), max(at.max_reorder_window, 1)))
        self.window = n
        self.loader._tuned["reorder_window"] = n
        return n

    # -- dispatch ------------------------------------------------------------
    def _pump(self) -> None:
        """Flatten sampler batches into sample tasks while the in-flight
        sample window has room (``outstanding`` batches times the actual
        per-batch sample count, matching the legacy prefetch window)."""
        if self._exhausted:
            return
        while (
            self._per_batch is None  # the first batch sizes the window
            or self._dispatched_samples - self._completed_samples
            < self.max_outstanding * self._per_batch
        ):
            try:
                task: BatchIndices = next(self._sampler_iter)
            except StopIteration:
                self._exhausted = True
                return
            if self._per_batch is None:
                self._per_batch = max(len(task.indices), 1)
            if self._next_bid is None:
                self._next_bid = task.batch_id
                self._bid_base = task.batch_id
                self._group_consumed = task.batch_id
            n = len(task.indices)
            if self._assembler is not None:
                self._assembler.begin_batch(task.batch_id, n)
                self._batch_indices[task.batch_id] = tuple(task.indices)
            elif self.strict:
                self._slots[task.batch_id] = [None] * n
                self._remaining[task.batch_id] = n
                self._batch_indices[task.batch_id] = tuple(task.indices)
            else:
                gid = self._next_gid - 1
                g = self._groups.get(gid)
                if g is None or g.closed or len(g.sizes) >= self.window:
                    if g is not None:
                        g.closed = True
                    gid = self._next_gid
                    self._next_gid += 1
                    g = _Group(task.batch_id)
                    self._groups[gid] = g
                g.sizes.append(n)
                self._gid_of_bid[task.batch_id] = gid
            self._dispatched_batches += 1
            self._dispatched_samples += n
            for pos, index in enumerate(task.indices):
                self.io.submit(_Sample(task.batch_id, pos, index))

    # -- assembly ------------------------------------------------------------
    def _absorb(self, s: _Sample, item: Any) -> None:
        self._completed_samples += 1
        if self._assembler is not None:
            # lane routing: the sample goes to its lane's collate and copy
            # thread; the composed batch comes back through done_q as a
            # _Composed token, landing in _ready
            self._assembler.add(s.batch_id, s.pos, item)
        elif self.strict:
            slots = self._slots[s.batch_id]
            slots[s.pos] = item
            self._remaining[s.batch_id] -= 1
            if self._remaining[s.batch_id] == 0:
                del self._remaining[s.batch_id]
                self._ready[s.batch_id] = self._slots.pop(s.batch_id)
        else:
            g = self._groups[self._gid_of_bid[s.batch_id]]
            g.buffer.append(item)
            g.indices.append(s.index)

    def _pop_ready(self) -> Optional[List[Any]]:
        """Return the next deliverable batch's items, or None."""
        if self.strict:
            if self._next_bid is not None and self._next_bid in self._ready:
                items = self._ready.pop(self._next_bid)
                self._shuffle.note_batch(
                    self._batch_indices.pop(self._next_bid, ()))
                self._next_bid += 1
                return items
            return None
        g = self._groups.get(self._cur_group)
        if g is None:
            return None
        if g.emitted < len(g.sizes):
            need = g.sizes[g.emitted]
            if len(g.buffer) >= need:
                items, g.buffer = g.buffer[:need], g.buffer[need:]
                idxs, g.indices = g.indices[:need], g.indices[need:]
                g.emitted += 1
                self._shuffle.note_batch(idxs)
                if g.emitted == len(g.sizes) and (g.closed or self._exhausted):
                    # last slot of a finished group: the consumer cursor may
                    # advance past it (resume replays partial groups only)
                    self._group_consumed = g.start_bid + len(g.sizes)
                return items
            return None
        # every dispatched slot of this group emitted; the group is complete
        # once a later group was opened or the sampler is exhausted
        if (g.closed or self._exhausted) and not g.buffer:
            self._group_consumed = g.start_bid + len(g.sizes)
            for bid in range(g.start_bid, g.start_bid + len(g.sizes)):
                self._gid_of_bid.pop(bid, None)
            del self._groups[self._cur_group]
            self._cur_group += 1
            return self._pop_ready()
        return None

    def _emit(self, items: Any) -> Any:
        if self._assembler is not None:
            # sharded delivery: the lanes already collated and copied every
            # row to the card; ``items`` is the composed device batch
            batch = self._assembler.hand_off(items)
        else:
            # absolute batch id, the coordinate space of the per-sample spans
            with self.tracer.span(
                STAGE_COLLATE, batch_id=self._bid_base + self._emitted_batches
            ):
                if self._staging is not None:
                    batch = self._staging.collate(items)
                else:
                    batch = self.loader.collate_fn(items)
            # collate is one full pass over the batch either way (np.stack
            # allocates+copies; staging copies into a reused buffer)
            if isinstance(batch, dict):
                self.tracer.count(BYTES_COPIED, shm_mod.item_nbytes(batch))
            # collate copied every view out: hand the shm slots back for reuse
            shm_mod.release_items(items)
        self._emitted_batches += 1
        # consumer cursor in absolute batch ids (resume starts past 0)
        consumed = self._bid_base + self._emitted_batches
        if not self.strict:
            # a windowed batch holds first-N-ready samples from its whole
            # group, so hold the cursor at the last fully emitted group's
            # end: a restart replays the partial group and loses no sample
            consumed = max(self._group_consumed, self._bid_base)
        self.loader._consumed = consumed
        return batch

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> "_PipelineIter":
        return self

    def __next__(self) -> Any:
        from repro_torch.core.loader import deliver_traced  # here to avoid a cycle

        return deliver_traced(self)

    def _next_impl(self) -> Any:
        if self._shutdown:
            raise StopIteration
        from repro_torch.core.loader import LoaderTimeout  # here to avoid a cycle

        deadline = time.monotonic() + self.cfg.timeout_s
        while True:
            items = self._pop_ready()
            if items is not None:
                self._pump()
                return self._emit(items)
            if (
                self._exhausted
                and self._completed_samples >= self._dispatched_samples
                and self._emitted_batches >= self._dispatched_batches
            ):
                self._finish_epoch()
                raise StopIteration
            self._pump()
            self.io.hedge_scan()
            try:
                s, payload = self.done_q.get(timeout=0.1)
            except queue.Empty:
                if self._shutdown:
                    # shut down from another thread (the device ring's
                    # close) while this consumer waited
                    raise StopIteration from None
                if time.monotonic() > deadline:
                    self.shutdown()
                    raise LoaderTimeout(
                        f"no sample within {self.cfg.timeout_s}s (dispatched="
                        f"{self._dispatched_samples}, "
                        f"completed={self._completed_samples})"
                    ) from None
                continue
            if isinstance(payload, _Failure):
                self.shutdown()
                raise payload.exc
            if isinstance(s, _Composed):
                # a lane finished a batch out of band: park it for the
                # strict in-order pop above
                self._ready[s.batch_id] = payload
                continue
            self._absorb(s, payload)

    def _finish_epoch(self) -> None:
        # the epoch drained: the loader feeds its epoch-cadence cache
        # controller (without this, cache_cadence="epoch" never runs here)
        self.shutdown()
        self.loader._note_epoch_end()

    # -- observability -------------------------------------------------------
    def stage_stats(self) -> Dict[str, Any]:
        """Live per-stage snapshot: executor widths, queue occupancy, flow
        counters; the queue numbers identify the bottleneck stage."""
        out: Dict[str, Any] = {
            "io_workers": self.io.gate.limit,
            "cpu_workers": self.cpu.width,
            "cpu_executor": self.cpu_kind,
            "outstanding_batches": self.max_outstanding,
            "decode_queue": self.decode_q.occupancy(),
            "done_queue": self.done_q.qsize(),
            "in_flight_samples": self._dispatched_samples - self._completed_samples,
            "emitted_batches": self._emitted_batches,
            "split": self.split,
            "reorder": "strict" if self.strict else f"window={self.window}",
            "shuffle": self._shuffle.snapshot(),
        }
        if self._budget:
            out["thread_budget"] = self._budget
        if self._staging is not None:
            # the reference's pool stats, and how many sets a CUDA ring
            # pinned in place (0 for any other consumer)
            out["staging"] = {**self._staging.stats(),
                              "registered": self._staging.registered}
        if self._proc_cpu is not None:
            stage = self._proc_cpu
            pool = stage.pool
            out["cpu_pool"] = {
                "workers": len(pool.workers),
                "crashes": pool.crashes,
                "respawns": pool.respawns,
                "requeued": stage.requeued,
            }
            if pool.last_error:
                out["cpu_pool"]["last_error"] = pool.last_error
            samples = stage.shm_samples + stage.pipe_samples
            tr: Dict[str, Any] = {
                "kind": self.transport,
                "shm_samples": stage.shm_samples,
                "pipe_samples": stage.pipe_samples,
                "fallbacks": dict(stage.fallbacks),
                "fallback_rate": (
                    round(sum(stage.fallbacks.values()) / samples, 4)
                    if samples else 0.0
                ),
                "bytes_copied": stage.bytes_copied,
            }
            if pool.shm_spec is not None:
                slot_bytes, slots = pool.shm_spec
                live = [w.slab for w in pool.workers if w.slab is not None]
                in_use = sum(sl.in_use for sl in live)
                peak = max((sl.peak for sl in live), default=0)
                total = slots * max(len(live), 1)
                tr.update(
                    slot_bytes=slot_bytes,
                    slab_slots=slots,
                    slab_cap=self._slab_cap,
                    slots_in_use=in_use,
                    slots_peak_per_worker=peak,
                    occupancy=round(in_use / total, 4) if total else 0.0,
                )
            out["transport"] = tr
        hedge = self.io.hedge
        if hedge is not None:
            out["hedges_issued"] = hedge.hedges_issued
            out["hedges_won"] = hedge.hedges_won
        if self._assembler is not None:
            # per-lane composed counts, collate and copy means: the lane-skew
            # signal the autotuner reads
            out["delivery"] = self._assembler.stats()
        return out

    # -- shutdown ------------------------------------------------------------
    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        # final snapshot for post-epoch observability: the loader holds this
        # iterator only weakly, but callers want stage_stats() after the epoch
        try:
            self.loader._last_stage_stats = self.stage_stats()
        except Exception:  # pragma: no cover - stats must never block exit
            pass
        self._stop.set()
        if self._assembler is not None:
            self._assembler.close()
        self.io.close()
        # join every CPU stage created this epoch (an executor-kind flip
        # leaves the paused one alive); the process POOL persists on the
        # loader, and only the stage's pump thread belongs to this iterator
        for stage in (self._thread_cpu, self._proc_cpu):
            if stage is not None:
                stage.join()

    def __del__(self) -> None:  # pragma: no cover - best effort
        try:
            self.shutdown()
        except Exception:
            pass
