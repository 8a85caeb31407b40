"""Worker layer: batch-level parallelism (paper Fig. 3/4).

A worker consumes :class:`BatchIndices` tasks from its index queue, loads the
items through its fetcher (sequential / thread-pool / asyncio — the paper's
three variants), collates, and puts ``(batch_id, batch)`` on the shared data
queue.  The threaded variant optionally *disassembles* several batches into
one item pool (``batch_pool``, Fig. 4 right) and reassembles them as the
items arrive.

Workers are threads (I/O releases the GIL; no pickling).  The
``startup_cost_s`` knob emulates the Process fork/spawn cost so the Fig. 8
lazy-initialization study is reproducible with threads.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import FIRST_COMPLETED, wait
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.fetcher import Fetcher, ThreadPoolFetcher
from repro_torch.core.sampler import BatchIndices
from repro_torch.core.tracing import NULL_TRACER, Tracer
from repro_torch.data.dataset import Item, MapDataset, collate

LOAD_BATCH = "load_batch"  # worker-side span: assemble one batch

_SENTINEL = None


class WorkerFailure:
    """Exception carrier placed on the data queue."""

    def __init__(self, batch_id: int, exc: BaseException) -> None:
        self.batch_id = batch_id
        self.exc = exc


class Worker:
    def __init__(
        self,
        worker_id: int,
        dataset: MapDataset,
        fetcher: Fetcher,
        index_queue: "queue.Queue",
        data_queue: "queue.Queue",
        *,
        collate_fn: Callable[[Sequence[Item]], Any] = collate,
        tracer: Tracer = NULL_TRACER,
        startup_cost_s: float = 0.0,
        batch_pool: int = 0,
    ) -> None:
        self.worker_id = worker_id
        self.dataset = dataset
        self.fetcher = fetcher
        self.index_queue = index_queue
        self.data_queue = data_queue
        self.collate_fn = collate_fn
        self.tracer = tracer
        self.startup_cost_s = startup_cost_s
        self.batch_pool = batch_pool
        self.ready = threading.Event()
        self.stop = threading.Event()
        # blocking waits inside the fetcher poll this so a stalled store
        # can't wedge the worker past shutdown
        self.fetcher.stop_event = self.stop
        self.thread = threading.Thread(
            target=self._run, name=f"loader-worker-{worker_id}", daemon=True
        )

    def start(self) -> None:
        self.thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        # a shutdown from another thread (the device ring's close) can land
        # between a lazy start's creation of the worker and its start(); the
        # worker then finds its stop flag and sentinel when it does start
        if self.thread.ident is not None:
            self.thread.join(timeout)

    # -- queue helpers with shutdown awareness -------------------------------
    def _put(self, obj: Any) -> bool:
        while not self.stop.is_set():
            try:
                self.data_queue.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        if self.startup_cost_s:
            time.sleep(self.startup_cost_s)  # emulated process spawn
        self.ready.set()
        try:
            if self.batch_pool > 0 and isinstance(self.fetcher, ThreadPoolFetcher):
                self._run_disassembly()
            else:
                self._run_simple()
        finally:
            self.fetcher.close()

    def _run_simple(self) -> None:
        while not self.stop.is_set():
            try:
                task = self.index_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if task is _SENTINEL:
                break
            assert isinstance(task, BatchIndices)
            try:
                with self.tracer.span(LOAD_BATCH, batch_id=task.batch_id,
                                      worker=self.worker_id):
                    items = self.fetcher.fetch(self.dataset, task.indices)
                    batch = self.collate_fn(items)
                if not self._put((task.batch_id, batch)):
                    break
            except BaseException as e:  # propagate to consumer
                if not self._put((task.batch_id, WorkerFailure(task.batch_id, e))):
                    break

    # -- batch disassembly (Fig. 4 right) ------------------------------------
    def _run_disassembly(self) -> None:
        pool: ThreadPoolFetcher = self.fetcher  # type: ignore[assignment]
        stop_after = False
        while not self.stop.is_set() and not stop_after:
            # take one batch (blocking), then greedily disassemble more until
            # the item pool holds >= batch_pool items.
            try:
                first = self.index_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is _SENTINEL:
                break
            batches: List[BatchIndices] = [first]
            n_items = len(first.indices)
            while n_items < self.batch_pool:
                try:
                    nxt = self.index_queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop_after = True
                    break
                batches.append(nxt)
                n_items += len(nxt.indices)
            try:
                self._fetch_pool(pool, batches)
            except BaseException as e:
                for b in batches:
                    if not self._put((b.batch_id, WorkerFailure(b.batch_id, e))):
                        return

    def _fetch_pool(self, pool: ThreadPoolFetcher, batches: List[BatchIndices]) -> None:
        t0s = {b.batch_id: time.monotonic() for b in batches}
        fut_meta = {}
        remaining: Dict[int, int] = {}
        results: Dict[int, List[Optional[Item]]] = {}
        for b in batches:
            remaining[b.batch_id] = len(b.indices)
            results[b.batch_id] = [None] * len(b.indices)
            for pos, idx in enumerate(b.indices):
                # submit_one routes through the fetcher's concurrency gate
                fut = pool.submit_one(self.dataset, idx)
                fut_meta[fut] = (b.batch_id, pos)
        pending = set(fut_meta)
        by_id = {b.batch_id: b for b in batches}
        while pending and not self.stop.is_set():
            done, pending = wait(pending, timeout=0.5, return_when=FIRST_COMPLETED)
            for fut in done:
                bid, pos = fut_meta[fut]
                results[bid][pos] = fut.result()  # may raise -> caller handles
                remaining[bid] -= 1
                if remaining[bid] == 0:
                    # reassemble in requested order (paper: sort after load)
                    items = results.pop(bid)
                    batch = self.collate_fn(items)  # type: ignore[arg-type]
                    self.tracer.record(
                        LOAD_BATCH, t0s[bid], time.monotonic(),
                        batch_id=bid, worker=self.worker_id, pool=True,
                    )
                    if not self._put((bid, batch)):
                        return
