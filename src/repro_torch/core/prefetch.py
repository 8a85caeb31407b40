"""Device prefetch ring — pinned host memory + asynchronous H2D.

Wraps a host-batch iterator; a background thread copies the next ``depth``
batches to the device while the current step runs, and records one
``batch_to_device`` span per batch (paper Fig. 1/2 magenta lane).

On CUDA a batch collated into staging buffers (a
:class:`~repro_torch.core.staging.StagedBatch`) is copied straight from
them with ``.to(device, non_blocking=True)`` on a side stream: the one host
copy was collate's.  :meth:`~repro_torch.core.staging.StagedBatch.pin`
registers a pooled buffer set in place the first time the ring copies from
it.  Any other batch goes host numpy -> ``.pin_memory()`` (a second host
copy) -> ``.to(...)``.  The copy's event is synchronized inside the span,
so the span covers the transfer and not just its enqueue; a staged batch's
buffers are released to their pool only after that event completed, never
before (the next collate would overwrite a buffer mid-DMA).  On the CPU,
``.to("cpu")`` returns the staging storage itself, so the release detaches
such a lease instead, and nothing is pinned.
``ingest_fn`` (the ``ingest_norm`` epilogue) runs right after the put, on the
same side stream; a second event marks the batch ready.  The consumer's
stream waits on that event before it touches the batch, and every tensor of
the batch is ``record_stream``-ed on the consumer's stream, so the caching
allocator does not hand its memory back to the side stream while the step
still reads it.

``transfer=False`` (sharded delivery, whose lanes already copied every
batch to the card) turns the ring into pacing plus the epilogue: it copies
nothing and records no ``batch_to_device`` span, ``ingest_fn`` still runs
(on the side stream, each input tensor ``record_stream``-ed there since the
lanes allocated it on their own streams), and a batch whose tensors are not
on the ring's device raises instead of being copied.
:attr:`DevicePrefetchRing.bytes_transferred` counts the host bytes the ring
copied to the device.

The consumer's wait for the next batch on the ring's queue is one
``ring_wait`` span, tagged with the batches handed out before it
(:attr:`DevicePrefetchRing.handed_out`).

``depth`` is adjustable live (:meth:`set_depth`): the in-flight window is
gated by an :class:`AdjustableSemaphore`.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.core.fetcher import AdjustableSemaphore
from repro_torch.core.tracing import BATCH_TO_DEVICE, NULL_TRACER, RING_WAIT, Tracer
from repro_torch.device import resolve_device


class _End:
    pass


class _Err:
    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class DevicePrefetchRing:
    def __init__(
        self,
        it: Iterator[Dict[str, np.ndarray]],
        *,
        depth: int = 2,
        max_depth: Optional[int] = None,
        transfer: bool = True,
        tracer: Tracer = NULL_TRACER,
        ingest_fn: Optional[Any] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.it = it
        depth = max(1, depth)
        self.max_depth = max(depth, max_depth or depth)
        # transfer=False: batches arrive on the device already (sharded
        # delivery); the ring paces them and runs the epilogue
        self.transfer = transfer
        self.bytes_transferred = 0
        self.handed_out = 0
        self.tracer = tracer
        # on-device ingest epilogue: a batch -> batch callable (see
        # repro_torch.kernels.ingest_norm.ops.make_ingest_fn) applied after the put
        self.ingest_fn = ingest_fn
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._slots = AdjustableSemaphore(depth)
        self._q: "queue.Queue" = queue.Queue()  # window bounded by _slots
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="device-prefetch", daemon=True)
        self._thread.start()

    @property
    def depth(self) -> int:
        return self._slots.limit

    def set_depth(self, depth: int) -> int:
        """Adjust the in-flight window; returns the applied (clamped) value."""
        d = max(1, min(int(depth), self.max_depth))
        self._slots.set_limit(d)
        return d

    def _put_device(self, batch: Dict[str, np.ndarray]):
        if not isinstance(batch, dict):
            raise TypeError(f"the ring transfers dict batches, got {type(batch).__name__}")
        if not self.transfer:
            return self._on_device(batch)
        self.bytes_transferred += sum(int(np.asarray(v).nbytes) for v in batch.values())
        # a StagedBatch: released to its pool once the copy has landed
        release = getattr(batch, "release_after", None)
        if not self._cuda:
            host = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
            with self.tracer.span(BATCH_TO_DEVICE):
                dev = {k: v.to(self.device) for k, v in host.items()}
            if release is not None:
                release(dev)  # .to("cpu") aliased the buffers: detached
            if self.ingest_fn is not None:
                dev = self.ingest_fn(dev)
            return dev, None
        # "staging" (the pool's own buffers, pinned in place once a set) or
        # "pin_memory" (a second host copy); either way inside the span
        pin = getattr(batch, "pin", None)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            with self.tracer.span(BATCH_TO_DEVICE) as extra:
                if pin is not None:
                    host, extra["source"] = pin()
                else:
                    host = {k: torch.from_numpy(np.asarray(v)).pin_memory()
                            for k, v in batch.items()}
                    extra["source"] = "pin_memory"
                dev = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
                copied = torch.cuda.Event()
                copied.record(self._stream)
                # block until the transfer lands so the span is honest
                copied.synchronize()
            # only now may the staging buffers be reused
            if release is not None:
                release(dev)
            if self.ingest_fn is not None:
                # launches on the side stream, the current stream here
                dev = self.ingest_fn(dev)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return dev, ready

    def _on_device(self, batch: Dict[str, Any]):
        """A batch already on the ring's device: no copy, the epilogue only."""
        for k, v in batch.items():
            where = v.device if isinstance(v, torch.Tensor) else type(v).__name__
            if where != self.device:
                raise ValueError(
                    f"transfer=False: batch[{k!r}] is on {where}, not {self.device}; "
                    "the ring copies nothing")
        if not self._cuda:
            dev = dict(batch)
            return (self.ingest_fn(dev) if self.ingest_fn is not None else dev), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = dict(batch)
            if self.ingest_fn is not None:
                for t in dev.values():
                    t.record_stream(self._stream)
                dev = self.ingest_fn(dev)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return dev, ready

    def _acquire_slot(self) -> bool:
        """Wait for a free ring slot, polling the stop flag."""
        while not self._stop.is_set():
            if self._slots.acquire(timeout=0.1):
                return True
        return False

    def _run(self) -> None:
        try:
            for batch in self.it:
                if self._stop.is_set():
                    return
                dev = self._put_device(batch)
                # slot acquired AFTER the transfer, matching the fixed-queue
                # behaviour (depth queued + 1 transferred-and-waiting)
                if not self._acquire_slot():
                    return
                self._q.put(dev)
            self._q.put(_End())
        except BaseException as e:  # propagate to the consumer
            self._q.put(_Err(e))

    def __iter__(self) -> "DevicePrefetchRing":
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        with self.tracer.span(RING_WAIT, handed=self.handed_out):
            item = self._q.get()
        if isinstance(item, _End):
            raise StopIteration
        if isinstance(item, _Err):
            raise item.exc
        self._slots.release()
        self.handed_out += 1
        dev, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in dev.values():
                t.record_stream(consumer)
        return dev

    def close(self, timeout: float = 30.0) -> None:
        """Stop prefetching: shut the source iterator down (if it can be) and
        wait for the ring's thread, so no transfer or ingest is still running
        when this returns."""
        self._stop.set()
        shutdown = getattr(self.it, "shutdown", None)
        if callable(shutdown):
            shutdown()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"device prefetch thread still running after {timeout}s")
