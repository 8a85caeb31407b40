"""Fetcher layer — the paper's §2.2 contribution.

The stock loader fetches the items of a batch *sequentially*
(:class:`SequentialFetcher` = ``_MapDatasetFetcher``).  We add the two
concurrent variants from the paper:

* :class:`ThreadPoolFetcher`  (= ``_ThreadedMapDatasetFetcher``) — a
  per-worker ``ThreadPoolExecutor`` with ``num_fetch_workers`` threads.
* :class:`AsyncioFetcher`     (= ``_AsyncMapDatasetFetcher``) — a per-worker
  event loop running ``num_fetch_workers``-bounded concurrent tasks against
  the dataset's async path.

Beyond the paper (fault tolerance at the data layer): transparent retry of
transient store errors and *hedged requests* — when a fetch exceeds a
p95-tracked deadline a duplicate is issued and the first response wins
(straggler mitigation for 1000-node deployments where tail GETs stall a
whole global batch).

The thread-pool fetcher gates submissions with an
:class:`AdjustableSemaphore` (a counting semaphore whose limit can change
live; the device ring's depth gate uses it too), so :meth:`Fetcher.resize`
is cheap and safe mid-epoch: the autotuner's fetch-concurrency knob.
"""
from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.data.dataset import Item, MapDataset
from repro_torch.data.store import TransientStoreError

MAX_RETRIES = 3


class FetchError(RuntimeError):
    pass


class AdjustableSemaphore:
    """Counting semaphore whose permit limit can be raised/lowered live.

    Raising the limit wakes blocked acquirers immediately; lowering it never
    interrupts holders — the surplus drains as permits are released.
    :meth:`DevicePrefetchRing.set_depth` moves its limit live.
    """

    def __init__(self, limit: int) -> None:
        if limit < 1:
            raise ValueError("limit must be >= 1")
        self._limit = limit
        self._held = 0
        self._cond = threading.Condition()

    @property
    def limit(self) -> int:
        with self._cond:
            return self._limit

    def set_limit(self, limit: int) -> None:
        if limit < 1:
            raise ValueError("limit must be >= 1")
        with self._cond:
            grew = limit > self._limit
            self._limit = limit
            if grew:
                self._cond.notify_all()

    def acquire(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            while self._held >= self._limit:
                if not self._cond.wait(timeout=timeout) and timeout is not None:
                    return False
            self._held += 1
            return True

    def release(self) -> None:
        with self._cond:
            self._held -= 1
            self._cond.notify()

    def __enter__(self) -> "AdjustableSemaphore":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class HedgeTracker:
    """Tracks recent fetch durations; deadline = max(min_s, p95 * factor).

    ``enabled`` can be flipped live (the autotuner's hedge knob): a disabled
    tracker keeps observing durations but fetchers skip the hedging path.
    """

    def __init__(self, factor: float = 3.0, min_s: float = 0.05, window: int = 256) -> None:
        self.factor = factor
        self.min_s = min_s
        self._durs: deque = deque(maxlen=window)
        self._lock = threading.Lock()
        self.hedges_issued = 0
        self.hedges_won = 0
        self.enabled = True

    def observe(self, dur: float) -> None:
        with self._lock:
            self._durs.append(dur)

    def deadline(self) -> float:
        with self._lock:
            if len(self._durs) < 8:
                return max(self.min_s, 1.0)
            xs = sorted(self._durs)
            p95 = xs[min(len(xs) - 1, int(0.95 * len(xs)))]
        return max(self.min_s, p95 * self.factor)


def retry_transient(fn: Callable[[int], Any], index: int) -> Any:
    """Call ``fn(index)`` retrying transient store errors — the single
    definition of the data-layer retry policy."""
    err: Optional[Exception] = None
    for _ in range(MAX_RETRIES):
        try:
            return fn(index)
        except TransientStoreError as e:  # injected/transient — retry
            err = e
    raise FetchError(f"item {index} failed after {MAX_RETRIES} retries") from err


async def aretry_transient(coro_fn: Callable[[int], Any], index: int) -> Any:
    """Async twin of :func:`retry_transient` (``coro_fn(index)`` awaited)."""
    err: Optional[Exception] = None
    for _ in range(MAX_RETRIES):
        try:
            return await coro_fn(index)
        except TransientStoreError as e:
            err = e
    raise FetchError(f"item {index} failed after {MAX_RETRIES} retries") from err


def _fetch_one_with_retry(dataset: MapDataset, index: int) -> Item:
    return retry_transient(dataset.__getitem__, index)


class Fetcher:
    """fetch(dataset, indices) -> items in the requested order."""

    name = "base"
    # set by the owning Worker so blocking waits stay shutdown-responsive
    stop_event: Optional[threading.Event] = None

    def fetch(self, dataset: MapDataset, indices: Sequence[int]) -> List[Item]:
        raise NotImplementedError

    @property
    def concurrency(self) -> int:
        return 1

    def resize(self, num_fetch_workers: int) -> int:
        """Adjust effective concurrency; returns the applied (clamped) value.
        Base/sequential fetchers are fixed at 1."""
        return self.concurrency

    def close(self) -> None:
        pass


class SequentialFetcher(Fetcher):
    """The vanilla PyTorch behaviour: items of a batch fetched one by one."""

    name = "sequential"

    def fetch(self, dataset: MapDataset, indices: Sequence[int]) -> List[Item]:
        return [_fetch_one_with_retry(dataset, i) for i in indices]


class ThreadPoolFetcher(Fetcher):
    """Within-batch parallelism via a thread pool (+ optional hedging).

    Threads are allocated up to ``hard_cap``; *effective* concurrency is
    gated by an :class:`AdjustableSemaphore`, so ``resize`` is cheap and safe
    mid-epoch.  All work — including the batch-disassembly path in
    :mod:`repro_torch.core.worker` — must enter the pool via
    :meth:`submit_one` so the gate is never bypassed (hedge duplicates alone
    run ungated, on a headroom thread).
    """

    name = "threaded"

    def __init__(
        self,
        num_fetch_workers: int = 16,
        hedge: Optional[HedgeTracker] = None,
        hard_cap: Optional[int] = None,
    ) -> None:
        self.hard_cap = max(num_fetch_workers, hard_cap or num_fetch_workers)
        self.hedge = hedge
        self._gate = AdjustableSemaphore(num_fetch_workers)
        # +1 headroom thread so a hedge duplicate can run while all gated
        # slots are busy with stragglers
        self._pool = ThreadPoolExecutor(
            max_workers=self.hard_cap + 1, thread_name_prefix="fetcher"
        )

    @property
    def concurrency(self) -> int:
        return self._gate.limit

    def resize(self, num_fetch_workers: int) -> int:
        n = max(1, min(int(num_fetch_workers), self.hard_cap))
        self._gate.set_limit(n)
        return n

    def _run_gated(self, dataset: MapDataset, index: int) -> Item:
        t0 = time.monotonic()
        try:
            return _fetch_one_with_retry(dataset, index)
        finally:
            self._gate.release()
            if self.hedge is not None:
                # true per-item service duration, recorded in the task itself
                # (not in the gather loop, whose view is skewed by gate/queue
                # waits), and while hedging is disabled too, so a re-enable
                # never acts on a stale p95 deadline
                self.hedge.observe(time.monotonic() - t0)

    def submit_one(self, dataset: MapDataset, index: int) -> "Future[Item]":
        """Submit a single gated item fetch (shared with the worker's
        batch-disassembly path).

        The permit is acquired BEFORE submission: work beyond the gate limit
        waits in the caller, not parked inside a pool thread, so the
        executor only spawns threads for actually-runnable work and the
        hedge headroom thread can never be starved by gated backlog.  The
        wait polls the owner's stop event so a stalled store cannot wedge a
        worker past shutdown."""
        stop = self.stop_event
        while not self._gate.acquire(timeout=0.2 if stop is not None else None):
            if stop is not None and stop.is_set():
                raise FetchError("fetcher shutting down")
        return self._pool.submit(self._run_gated, dataset, index)

    def fetch(self, dataset: MapDataset, indices: Sequence[int]) -> List[Item]:
        futures = [self.submit_one(dataset, i) for i in indices]
        if self.hedge is not None and self.hedge.enabled:
            return self._gather_hedged(dataset, indices, futures)
        return [f.result() for f in futures]

    def _gather_hedged(self, dataset, indices, futures) -> List[Item]:
        # durations feeding the p95 deadline are recorded by _run_gated;
        # this loop only decides when a wait has become a straggler
        out: List[Optional[Item]] = [None] * len(indices)
        for pos, (i, fut) in enumerate(zip(indices, futures)):
            done, _ = wait([fut], timeout=self.hedge.deadline())
            if not done:
                # straggler: issue an ungated duplicate (headroom thread),
                # first response wins
                self.hedge.hedges_issued += 1
                dup = self._pool.submit(_fetch_one_with_retry, dataset, i)
                done, _ = wait([fut, dup], return_when=FIRST_COMPLETED)
                winner = done.pop()
                if winner is dup:
                    self.hedge.hedges_won += 1
                out[pos] = winner.result()
            else:
                out[pos] = fut.result()
        return out  # type: ignore[return-value]

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class AsyncioFetcher(Fetcher):
    """Within-batch concurrency on a single thread via asyncio, bounded by a
    per-``fetch`` semaphore of ``num_fetch_workers``: created per call from
    the current value, so ``resize`` takes effect at the next batch."""

    name = "asyncio"

    def __init__(self, num_fetch_workers: int = 16, hard_cap: Optional[int] = None) -> None:
        self.hard_cap = max(num_fetch_workers, hard_cap or num_fetch_workers)
        self._num_fetch_workers = num_fetch_workers
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="asyncio-fetcher", daemon=True
        )
        self._thread.start()

    @property
    def concurrency(self) -> int:
        return self._num_fetch_workers

    def resize(self, num_fetch_workers: int) -> int:
        n = max(1, min(int(num_fetch_workers), self.hard_cap))
        self._num_fetch_workers = n
        return n

    async def _afetch_one(self, dataset: MapDataset, index: int,
                          sem: asyncio.Semaphore) -> Item:
        async with sem:
            return await aretry_transient(dataset.aget_item, index)

    async def _afetch(self, dataset: MapDataset, indices: Sequence[int]) -> List[Item]:
        sem = asyncio.Semaphore(self._num_fetch_workers)
        tasks = [
            asyncio.ensure_future(self._afetch_one(dataset, i, sem)) for i in indices
        ]
        # results arrive out of order; gather restores the requested order
        return list(await asyncio.gather(*tasks))

    def fetch(self, dataset: MapDataset, indices: Sequence[int]) -> List[Item]:
        fut = asyncio.run_coroutine_threadsafe(self._afetch(dataset, indices), self._loop)
        return fut.result()

    def close(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
        if not self._loop.is_running():
            self._loop.close()


def make_fetcher(impl: str, num_fetch_workers: int,
                 hedge: Optional[HedgeTracker] = None,
                 hard_cap: Optional[int] = None) -> Fetcher:
    if impl == "vanilla":
        return SequentialFetcher()
    if impl == "threaded":
        return ThreadPoolFetcher(num_fetch_workers, hedge=hedge, hard_cap=hard_cap)
    if impl == "asyncio":
        return AsyncioFetcher(num_fetch_workers, hard_cap=hard_cap)
    raise ValueError(f"unknown fetcher impl {impl!r}")
