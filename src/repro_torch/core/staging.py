"""Pinned host staging: collate straight into reusable page-aligned buffers.

The default collate (``np.stack`` per key) allocates a fresh batch-sized
array every step, and the ring then makes a second host copy of it into
pinned memory before the copy to the card.  :class:`HostBatchPool` keeps a
small pool of page-aligned host buffer sets, one bucket per batch layout,
and assembles each batch row by row straight into a leased set: the one copy
collate always paid, into warm, reused memory that the card can DMA from.

Pinning follows the consumer, not the machine.  The pool allocates plain
page-aligned numpy buffers and never touches CUDA.  A device prefetch ring
that copies to a card calls :meth:`StagedBatch.pin`: the first time it
copies from a pooled set, the set's memory is registered with the CUDA
driver in place (``cudaHostRegister``), and it stays registered for as long
as the memory lives (a finalizer on each allocation unregisters it before
it is freed), so every later lease of the set copies with no pinning cost.
A lease past the pool's depth, whose buffers are dropped after one batch, is
copied into fresh pinned memory by ``.pin_memory()`` instead.  A CPU
consumer pins nothing and creates no CUDA context.

Lifecycle: :meth:`HostBatchPool.collate` leases a buffer set and returns a
:class:`StagedBatch` (a plain dict of numpy arrays to every consumer);
whoever finishes the transfer calls :meth:`StagedBatch.release_after` with
the device-side result (the ring does, after the copy's event completed).
A batch that is never released is recycled by GC (``weakref.finalize``), so
forgetting the release costs reuse, never correctness.  Leases beyond
``depth`` allocate ephemeral buffers that are dropped instead of pooled.

The sharp edge: recycling a buffer whose copy has not landed lets the next
collate overwrite it mid-DMA, and on the CPU ``t.to("cpu")`` returns the
same storage, so the "device" batch aliases the staging buffer itself.
``release_after`` compares ``data_ptr()`` against the buffers and detaches
(drops, never pools) any lease the result aliases; on the card, where H2D
is a real copy, every lease recycles.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

PAGE = 4096  # page alignment: cudaHostRegister pins whole pages


class _Bufs(dict):
    """One buffer set (name -> page-aligned array); ``pinned`` once a CUDA
    consumer registered its memory in place."""

    pinned = False


def _aligned_empty(shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    """A C-contiguous array whose data pointer is PAGE-aligned."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    raw = np.empty(nbytes + PAGE, dtype=np.uint8)
    off = (-raw.ctypes.data) % PAGE
    return raw[off:off + nbytes].view(dtype).reshape(shape)


def _unregister(cudart, ptr: int) -> None:
    err = cudart.cudaHostUnregister(ptr)
    if err != cudart.cudaError.success:
        raise RuntimeError(f"cudaHostUnregister({ptr:#x}) failed: "
                           f"{cudart.cudaGetErrorString(err)}")


def _register_in_place(a: np.ndarray) -> None:
    """Pin ``a``'s memory in place until the allocation behind it is freed:
    a finalizer on that allocation unregisters it first (numpy clears an
    array's weak references before it frees the array's memory)."""
    import torch

    cudart = torch.cuda.cudart()
    ptr = a.ctypes.data
    err = cudart.cudaHostRegister(ptr, a.nbytes, 0)
    if err != cudart.cudaError.success:
        raise RuntimeError(f"cudaHostRegister({ptr:#x}, {a.nbytes}) failed: "
                           f"{cudart.cudaGetErrorString(err)}")
    owner = a
    while isinstance(owner.base, np.ndarray):
        owner = owner.base
    # at interpreter exit the process's memory goes with the CUDA context
    weakref.finalize(owner, _unregister, cudart, ptr).atexit = False


def buffers_aliased(dev: Any, bufs: Mapping[str, np.ndarray]) -> bool:
    """Whether any tensor in ``dev`` (a dict or sequence) points into one of
    the staging buffers ``bufs``: the transfer returned the host storage
    itself (``.to("cpu")``), so the buffers are still live."""
    spans = [(a.ctypes.data, a.ctypes.data + a.nbytes)
             for a in bufs.values() if a.nbytes]
    leaves = dev.values() if hasattr(dev, "values") else dev
    for leaf in leaves:
        ptr = getattr(leaf, "data_ptr", None)
        if callable(ptr) and any(lo <= ptr() < hi for lo, hi in spans):
            return True
    return False


class StagedBatch(dict):
    """A collated batch living in pooled buffers.  Behaves exactly like the
    dict ``np.stack``-collate produces; ``release()`` recycles the buffers
    (idempotent: double release and GC-release never double-pool), and
    ``release_after(dev)`` is the transfer-time variant that detaches
    instead when the result aliases the buffers (see module docstring)."""

    __slots__ = ("_pool", "_key", "_bufs", "_released", "_finalizer",
                 "_pooled_lease", "__weakref__")

    def __init__(self, values: Dict[str, np.ndarray], pool: "HostBatchPool",
                 key, bufs: _Bufs, pooled: bool = True) -> None:
        super().__init__(values)
        self._pool = pool
        self._key = key
        self._bufs = bufs
        self._pooled_lease = pooled
        self._released = False
        # GC fallback: the finalizer holds (pool, key, bufs), NOT the batch,
        # so an unreleased batch returns its buffers when collected
        self._finalizer = weakref.finalize(self, pool._give_back, key, bufs)

    @property
    def pooled(self) -> bool:
        """Whether this lease's set belongs to the pool (False for a lease
        served past the pool's depth)."""
        return self._pooled_lease

    def pin(self) -> Tuple[Dict[str, Any], str]:
        """The batch as pinned host tensors for a copy to the card, and
        their source: ``"staging"`` when they are this lease's own pooled
        buffers, registered in place the first time the set is copied
        from; ``"pin_memory"`` for a lease past the pool's depth, which is
        copied into fresh pinned memory instead.  Only a CUDA consumer
        calls this."""
        import torch

        if not self._pooled_lease:
            return {k: torch.from_numpy(v).pin_memory() for k, v in self.items()}, "pin_memory"
        if not self._bufs.pinned:
            for a in self._bufs.values():
                if a.nbytes:
                    _register_in_place(a)
            self._bufs.pinned = True
            self._pool._count_registered()
        return {k: torch.from_numpy(v) for k, v in self.items()}, "staging"

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._finalizer.detach()
            self._pool._give_back(self._key, self._bufs)

    def detach(self) -> None:
        """Permanently drop this lease: the buffers are still referenced
        outside the pool and must never be reused."""
        if not self._released:
            self._released = True
            self._finalizer.detach()
            self._pool._drop(self._key, self._pooled_lease)

    def release_after(self, dev: Any) -> None:
        """Recycle after a finished transfer whose result is ``dev``, unless
        the result aliases our buffers, in which case detach."""
        if buffers_aliased(dev, self._bufs):
            self.detach()
        else:
            self.release()


class HostBatchPool:
    """Pool of reusable page-aligned host buffer sets, bucketed by batch
    layout.  ``collate(items)`` is a drop-in for the default np.stack
    collate (scalar values become stacked 1-D arrays, arrays gain a leading
    batch dim) whose output buffers are leased from the pool."""

    def __init__(self, depth: int = 2) -> None:
        self.depth = max(1, int(depth))
        self._lock = threading.Lock()
        self._free: Dict[Any, List[_Bufs]] = {}
        self._pooled: Dict[Any, int] = {}  # buffer sets alive per bucket
        self.leases = 0
        self.reuses = 0
        self.allocs = 0
        self.ephemeral = 0  # leases served past depth (not pooled on return)
        self.detached = 0  # leases dropped because the result aliased them
        self.registered = 0  # sets a CUDA consumer pinned in place

    # -- pool plumbing -------------------------------------------------------
    def _lease(self, key, arrays: Sequence[Tuple[str, np.ndarray]],
               n: int) -> Tuple[_Bufs, bool]:
        with self._lock:
            self.leases += 1
            bucket = self._free.get(key)
            if bucket:
                self.reuses += 1
                return bucket.pop(), True
            pooled = self._pooled.get(key, 0) < self.depth
            if pooled:
                self._pooled[key] = self._pooled.get(key, 0) + 1
                self.allocs += 1
            else:
                self.ephemeral += 1
        bufs = _Bufs((name, _aligned_empty((n,) + a.shape, a.dtype)) for name, a in arrays)
        return bufs, pooled

    def _give_back(self, key, bufs: _Bufs) -> None:
        with self._lock:
            bucket = self._free.setdefault(key, [])
            if len(bucket) < self.depth:
                bucket.append(bufs)
            # else: an ephemeral (past-depth) set — let GC take it

    def _drop(self, key, pooled: bool) -> None:
        """A lease detached (its buffers escaped into the transfer's
        result): forget it so a future lease may allocate a fresh set."""
        with self._lock:
            self.detached += 1
            if pooled and self._pooled.get(key, 0) > 0:
                self._pooled[key] -= 1

    def _count_registered(self) -> None:
        with self._lock:
            self.registered += 1

    # -- the collate ---------------------------------------------------------
    def collate(self, items: Sequence[Mapping[str, Any]]) -> StagedBatch:
        first = items[0]
        arrays = [(k, np.asarray(first[k])) for k in first]
        n = len(items)
        key = (n,) + tuple((k, a.dtype.str, a.shape) for k, a in arrays)
        bufs, pooled = self._lease(key, arrays, n)
        for name, a0 in arrays:
            out = bufs[name]
            out[0] = a0
            for i in range(1, n):
                out[i] = np.asarray(items[i][name])
        return StagedBatch(dict(bufs), self, key, bufs, pooled)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "depth": self.depth,
                "buckets": len(self._pooled),
                "leases": self.leases,
                "reuses": self.reuses,
                "allocs": self.allocs,
                "ephemeral": self.ephemeral,
                "detached": self.detached,
            }
