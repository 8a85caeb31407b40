"""Shared-memory sample transport for the process CPU stage.

The pipe transport pickles every decoded sample through the result pipe:
one full serialize in the worker, one full deserialize in the parent — fine
at tens of kB, wasteful at MB-scale decoded images.  This module is the
zero-copy alternative (``PipelineConfig.transport="shm"``): the parent
preallocates one shared-memory slab per worker, split into fixed-size slots;
the worker writes each decoded sample's arrays back-to-back into a free slot
(its ONLY copy) and ships a tiny ``(slot, generation, [(key, dtype, shape,
offset)])`` handle over the existing pipe; the parent materialises numpy
views directly into the slab.

Correctness hinges on three rules:

* **Slot ownership.**  The worker owns the free-list.  The parent never
  allocates; it only *returns* slots by queueing ``(slot, gen)`` pairs that
  the pump loop flushes back over the command pipe after collate has copied
  the views out (``ShmItem.release``).
* **Generation counters.**  Each slot carries a generation, bumped on every
  free.  A stale release (double release, release after an epoch reset)
  carries an old generation and is ignored, so a slot can never be handed
  out twice concurrently.
* **Crash safety.**  The PARENT creates (and therefore owns) every segment,
  so views already delivered stay valid after a worker dies; a worker that
  dies mid-slot-write simply never sends the handle — the parent still holds
  the raw bytes and retries the sample elsewhere (pipeline's normal crash
  path), and the dead worker's whole slab is retired with it.

Samples that don't fit a slot (oversized) or aren't plain numeric arrays
(ragged/object dtype), and moments when every slot is in flight, fall back
to the pickle pipe per-sample — the fast path is an optimisation, never a
correctness constraint.

The reference's module, with its handle layout and slot rules, so the two
packages' workers and parents pack and read slots the same way.  It
imports no ``torch``: spawned CPU workers load it.
"""
from __future__ import annotations

import threading
from collections import deque
from multiprocessing import shared_memory
from typing import Any, Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# per-array alignment inside a slot (cache line; also keeps every view's
# base address aligned for any dtype)
_ALIGN = 64

# fallback reasons (worker-reported, parent-aggregated in stage stats)
FALLBACK_OVERSIZE = "oversize"  # sample larger than one slot
FALLBACK_NO_SLOT = "no_slot"  # every usable slot in flight
FALLBACK_RAGGED = "ragged"  # non-numeric / object-dtype value

# handle field layout: (key, dtype_str, shape, offset_in_slot)
Field = Tuple[str, str, Tuple[int, ...], int]
# wire handle: (slot, generation, payload_nbytes, fields)
Handle = Tuple[int, int, int, Tuple[Field, ...]]


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def item_nbytes(item: Mapping[str, Any]) -> int:
    """Total array payload of one sample dict (the unit of copy accounting)."""
    total = 0
    for v in item.values():
        a = np.asarray(v)
        if a.dtype != object:
            total += a.nbytes
    return total


def release_items(items: Sequence[Any]) -> None:
    """Return any shm-backed items' slots to their workers (idempotent;
    non-shm items pass through untouched).  Called after collate has copied
    the views out."""
    for it in items:
        rel = getattr(it, "release", None)
        if callable(rel):
            rel()


class ShmItem(dict):
    """A decoded sample whose array values are views into a worker's slab.

    Drop-in for the plain dicts the pipe transport delivers — collate and
    datasets only ever index it — plus a ``release()`` that hands the slot
    back for reuse.  Safe to release exactly once; later calls (and releases
    after the slab was retired by a worker crash) are no-ops.
    """

    __slots__ = ("_slab", "_slot", "_gen", "_released")

    def __init__(self, values: Dict[str, Any], slab: "ParentSlab",
                 slot: int, gen: int) -> None:
        super().__init__(values)
        self._slab = slab
        self._slot = slot
        self._gen = gen
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._slab.queue_free(self._slot, self._gen)

    def __reduce__(self):
        # crossing a process boundary would detach the views from the slab's
        # lifetime; materialise a plain dict instead
        return (dict, (dict(self),))


class ParentSlab:
    """Parent-side handle for one worker's slab: creates/owns the segment,
    materialises views, and batches freed slots for the pump loop to flush
    back to the worker."""

    def __init__(self, slot_bytes: int, slots: int) -> None:
        self.slot_bytes = int(slot_bytes)
        self.slots = int(slots)
        self.shm = shared_memory.SharedMemory(
            create=True, size=max(self.slot_bytes * self.slots, 1))
        self.name = self.shm.name
        self._lock = threading.Lock()
        self._freed: List[Tuple[int, int]] = []
        self.in_use = 0
        self.peak = 0
        self.retired = False
        self._unlinked = False

    def spec(self) -> Tuple[str, int, int]:
        """(name, slot_bytes, slots) — what the worker needs to attach."""
        return (self.name, self.slot_bytes, self.slots)

    def view_item(self, handle: Handle) -> ShmItem:
        slot, gen, _nbytes, fields = handle
        base = slot * self.slot_bytes
        values: Dict[str, Any] = {}
        for key, dtype, shape, off in fields:
            values[key] = np.ndarray(
                shape, dtype=np.dtype(dtype), buffer=self.shm.buf,
                offset=base + off)
        with self._lock:
            self.in_use += 1
            self.peak = max(self.peak, self.in_use)
        return ShmItem(values, self, slot, gen)

    def queue_free(self, slot: int, gen: int) -> None:
        with self._lock:
            self.in_use -= 1
            if not self.retired:
                self._freed.append((slot, gen))

    def drain_freed(self) -> List[Tuple[int, int]]:
        with self._lock:
            if not self._freed:
                return []
            out, self._freed = self._freed, []
            return out

    def reset_accounting(self) -> None:
        """New epoch: the worker reset its free-list wholesale, so pending
        frees are stale and in-flight counts restart from zero."""
        with self._lock:
            self._freed.clear()
            self.in_use = 0

    def unlink(self) -> None:
        if not self._unlinked:
            self._unlinked = True
            try:
                self.shm.unlink()
            except FileNotFoundError:  # pragma: no cover - already gone
                pass

    def retire(self) -> None:
        """Owner worker died: stop queueing frees and drop the filesystem
        name now (already-delivered views stay valid — the mapping lives
        until they are garbage collected)."""
        with self._lock:
            self.retired = True
            self._freed.clear()
        self.unlink()

    def close(self) -> None:
        self.unlink()
        try:
            self.shm.close()
        except BufferError:
            # undelivered views still alive somewhere (e.g. shutdown with
            # batches in flight); the segment is unlinked, so the mapping is
            # reclaimed when the views go away — nothing leaks past the
            # process.
            pass


def close_slabs(slabs: List[ParentSlab]) -> None:
    """weakref.finalize target for the process pool: unlink every segment at
    interpreter exit even if the loader never closed the pool."""
    for slab in slabs:
        slab.close()


class SlabWriter:
    """Worker-side slab access: attaches to the parent's segment, owns the
    free-list + generation counters, and packs sample dicts into slots.

    Runs single-threaded inside the worker loop, so no locking.  ``cap``
    bounds how many slots may be used (the autotuner's live slab-pressure
    knob — lowering it just makes allocation fail sooner, forcing pickle
    fallback; never corrupts in-flight slots).
    """

    def __init__(self, name: str, slot_bytes: int, slots: int) -> None:
        self.shm = shared_memory.SharedMemory(name=name)
        # NOTE on the resource tracker: spawn children inherit the PARENT's
        # tracker process, so CPython's register-on-attach here is a set
        # no-op (the parent registered the name at create).  Do NOT
        # unregister "to fix double registration" — that would strip the
        # parent's registration and the parent's unlink would then race a
        # missing cache entry (tracker KeyError stderr spew) and, worse,
        # nothing would reclaim the segment if the parent died uncleanly.
        self.slot_bytes = int(slot_bytes)
        self.slots = int(slots)
        self.cap = self.slots
        self.gens = [0] * self.slots
        self.free: Deque[int] = deque(range(self.slots))

    def _take_slot(self) -> Optional[int]:
        # respect the live cap: skim past out-of-cap slot ids (they rejoin
        # the deque on free and become usable again if the cap rises)
        for _ in range(len(self.free)):
            slot = self.free.popleft()
            if slot < self.cap:
                return slot
            self.free.append(slot)
        return None

    def try_pack(self, item: Mapping[str, Any]):
        """Pack one sample into a free slot.

        Returns ``(handle, None)`` on success or ``(None, reason)`` when the
        sample must take the pickle fallback.  The single memcpy into the
        slab here is the shm transport's ONLY per-sample copy.
        """
        arrays: List[Tuple[str, np.ndarray]] = []
        total = 0
        for key, value in item.items():
            arr = np.asarray(value)
            if arr.dtype == object or arr.dtype.hasobject:
                return None, FALLBACK_RAGGED
            arrays.append((key, arr))
            total = _aligned(total + arr.nbytes)
        if total > self.slot_bytes:
            return None, FALLBACK_OVERSIZE
        slot = self._take_slot()
        if slot is None:
            return None, FALLBACK_NO_SLOT
        base = slot * self.slot_bytes
        fields: List[Field] = []
        off = 0
        nbytes = 0
        for key, arr in arrays:
            dst = np.ndarray(arr.shape, dtype=arr.dtype, buffer=self.shm.buf,
                             offset=base + off)
            np.copyto(dst, arr)
            fields.append((key, arr.dtype.str, arr.shape, off))
            nbytes += arr.nbytes
            off = _aligned(off + arr.nbytes)
        handle: Handle = (slot, self.gens[slot], nbytes, tuple(fields))
        return handle, None

    def free_slots(self, pairs: Sequence[Tuple[int, int]]) -> None:
        for slot, gen in pairs:
            if 0 <= slot < self.slots and self.gens[slot] == gen:
                self.gens[slot] += 1
                self.free.append(slot)

    def reset(self) -> None:
        """Epoch boundary: reclaim every slot (handles the parent dropped
        without releasing — e.g. an iterator abandoned mid-epoch)."""
        for slot in range(self.slots):
            self.gens[slot] += 1
        self.free = deque(range(self.slots))

    def set_cap(self, cap: int) -> None:
        self.cap = max(1, min(int(cap), self.slots))

    def close(self) -> None:
        try:
            self.shm.close()
        except BufferError:  # pragma: no cover - views alive at exit
            pass
