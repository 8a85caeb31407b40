"""Tiered cache subsystem — the hot tier behind the paper's 12x S3 win.

The paper's Varnish cache (§2.4) only pays off when the hot tier absorbs
repeat reads; this module makes that tier a first-class, *tunable* subsystem:

* :class:`MemoryTierCache` — sharded, lock-striped in-process LRU bounded by
  bytes.  Shard count 1 gives exact global LRU (the legacy ``CachedStore``
  semantics); more shards trade strict LRU for reduced lock contention.
* :class:`DiskTierCache`  — **bounded** on-disk tier: atomic tmp+rename
  writes, LRU eviction by bytes, a pluggable admission policy, and crash
  recovery (orphaned ``*.tmp*`` files older than ``tmp_grace_s`` are purged
  — a *fresh* tmp belongs to a live writer in another process — and
  surviving entries re-indexed, oldest-mtime first, on init).  Capacity is
  *reserved before the write*, so parallel writers can never overshoot
  ``capacity_bytes``.  Two multi-host modes (``repro_torch.core.coord``) make the
  tier safe when several processes/hosts share one directory: ``journal``
  replaces the in-process index with a cross-process ``fcntl``-locked byte
  journal, and ``shard`` partitions the keyspace with
  :func:`~repro_torch.core.coord.host_shard` (each host accounts only its own
  shard but opportunistically reads peers' entries off the shared disk).
* :class:`TieredCacheStore` — :class:`~repro_torch.data.store.ObjectStore` facade
  stacking memory over disk over the origin store, with sync ``get`` and
  async-safe ``aget`` (disk I/O is offloaded to the default executor), disk
  hits promoted to memory, and per-GET ``cache_get`` spans recorded through
  :mod:`repro_torch.core.tracing` (``tier=memory|disk|origin``).

Admission policies (applied to the disk tier, where a wasted write costs
I/O *and* evicts something useful):

* ``admit-all``       — cache every miss (the legacy behaviour),
* ``size-threshold``  — only items below a byte threshold (huge objects
  would sweep the whole tier for one future hit),
* ``second-hit``      — admit on the second sighting of a key (Bloom-filter
  based; one-touch scans never pollute the cache),
* ``tinylfu``         — hit-rate-aware frequency admission: a count-min
  sketch with periodic aging estimates each key's recency-weighted access
  frequency (tier hits feed it too), and a miss is admitted only once the
  estimate clears a threshold.

Capacities and the admission policy are runtime-adjustable
(``set_memory_capacity`` / ``set_disk_capacity`` / ``set_admission``), which
is what lets ``repro_torch.core.autotune`` drive them as knobs.

The port's copy names its entry files as the reference does (``_fname``,
``_shard_prefix``) and accounts them through the same journal format, so a
disk tier written by either package is reopened by the other.  The module
imports no ``torch``; the store stays in the loader's process, and only
bytes cross to CPU worker processes.
"""
from __future__ import annotations

import asyncio
import hashlib
import os
import threading
import time
from abc import ABC, abstractmethod
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.coord import SharedDiskJournal, host_shard
from repro_torch.core.tracing import CACHE_GET, NULL_TRACER, Tracer


@dataclass(frozen=True)
class CacheTierStats:
    """Unified per-tier counters (a point-in-time snapshot)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    admitted: int = 0
    rejected: int = 0  # admission-policy / capacity rejections only
    write_failures: int = 0  # I/O errors writing the tier (disk full, EMFILE)
    bytes_used: int = 0
    bytes_admitted: int = 0
    bytes_evicted: int = 0
    shard_foreign: int = 0  # shard-mode puts skipped: key owned by a peer host

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


# ---------------------------------------------------------------------------
# Admission policies
# ---------------------------------------------------------------------------


class AdmissionPolicy(ABC):
    """Decides whether a missed object earns a slot in the tier."""

    name: str = "?"

    @abstractmethod
    def admit(self, key: str, size: int) -> bool: ...


class AdmitAll(AdmissionPolicy):
    name = "admit-all"

    def admit(self, key: str, size: int) -> bool:
        return True


class SizeThresholdAdmission(AdmissionPolicy):
    """Reject items above ``max_item_bytes`` — one giant object can sweep the
    whole tier for a single future hit."""

    name = "size-threshold"

    def __init__(self, max_item_bytes: int) -> None:
        self.max_item_bytes = int(max_item_bytes)

    def admit(self, key: str, size: int) -> bool:
        return size <= self.max_item_bytes


class _BloomFilter:
    """Small thread-safe Bloom filter (blake2b-derived indices)."""

    def __init__(self, num_bits: int = 1 << 17, num_hashes: int = 4) -> None:
        self._nbits = num_bits
        self._k = num_hashes
        self._bits = bytearray(num_bits // 8)
        self._lock = threading.Lock()

    def _indices(self, key: str) -> List[int]:
        h = hashlib.blake2b(key.encode(), digest_size=4 * self._k).digest()
        return [
            int.from_bytes(h[4 * i: 4 * i + 4], "little") % self._nbits
            for i in range(self._k)
        ]

    def test_and_add(self, key: str) -> bool:
        """Return whether ``key`` was (probably) already present; add it."""
        idxs = self._indices(key)
        with self._lock:
            present = all(self._bits[i >> 3] & (1 << (i & 7)) for i in idxs)
            for i in idxs:
                self._bits[i >> 3] |= 1 << (i & 7)
        return present


class SecondHitAdmission(AdmissionPolicy):
    """Admit a key only on its *second* sighting: one-touch scan traffic
    (e.g. a single validation pass) never pollutes the tier."""

    name = "second-hit"

    def __init__(self, num_bits: int = 1 << 17) -> None:
        self._seen = _BloomFilter(num_bits=num_bits)

    def admit(self, key: str, size: int) -> bool:
        return self._seen.test_and_add(key)


# translate table halving every byte — ages the whole sketch in one C pass
_HALVE = bytes(b >> 1 for b in range(256))


class _FreqSketch:
    """Count-min sketch with saturating 4-bit-style counters and periodic
    aging (every counter halves once ``sample_window`` increments have been
    observed) — the TinyLFU frequency estimator.  Aging is what makes the
    estimate *recency-weighted*: a key hot last epoch but cold since decays
    back toward zero instead of staying admitted forever."""

    _MAX = 15

    def __init__(self, num_counters: int = 1 << 16, num_hashes: int = 4,
                 sample_window: int = 0) -> None:
        self._n = num_counters
        self._k = num_hashes
        self._counts = bytearray(num_counters)
        self._window = sample_window or 8 * num_counters
        self._ops = 0
        self._ages = 0
        self._lock = threading.Lock()

    def _indices(self, key: str) -> List[int]:
        h = hashlib.blake2b(key.encode(), digest_size=4 * self._k).digest()
        return [
            int.from_bytes(h[4 * i: 4 * i + 4], "little") % self._n
            for i in range(self._k)
        ]

    def add(self, key: str) -> int:
        """Count one access; return the post-increment min estimate."""
        idxs = self._indices(key)
        with self._lock:
            self._ops += 1
            if self._ops >= self._window:
                self._counts = bytearray(self._counts.translate(_HALVE))
                self._ops = 0
                self._ages += 1
            for i in idxs:
                if self._counts[i] < self._MAX:
                    self._counts[i] += 1
            return min(self._counts[i] for i in idxs)

    def estimate(self, key: str) -> int:
        idxs = self._indices(key)
        with self._lock:
            return min(self._counts[i] for i in idxs)


class TinyLFUAdmission(AdmissionPolicy):
    """Hit-rate-aware TinyLFU-style admission: a miss earns a slot only once
    the key's *recency-weighted* access frequency clears ``threshold``.

    Differences from :class:`SecondHitAdmission` (the Bloom doorkeeper):

    * the frequency sketch **ages** — counters halve every ``sample_window``
      observations, so a key that stopped being accessed has to re-prove
      itself instead of staying admitted on ancient history;
    * tier **hits feed the sketch too** (:meth:`record`, wired by
      ``DiskTierCache.get``), so the estimate tracks the key's real access
      rate, not just how often it missed.
    """

    name = "tinylfu"

    def __init__(self, num_counters: int = 1 << 16, threshold: int = 2,
                 sample_window: int = 0) -> None:
        self._sketch = _FreqSketch(num_counters, sample_window=sample_window)
        self.threshold = threshold

    def admit(self, key: str, size: int) -> bool:
        return self._sketch.add(key) >= self.threshold

    def record(self, key: str) -> None:
        """Count a tier hit (keeps resident keys' frequency warm across
        aging — the 'hit-rate-aware' half of the policy)."""
        self._sketch.add(key)

    def estimate(self, key: str) -> int:
        return self._sketch.estimate(key)


ADMISSION_KINDS = ("admit-all", "size-threshold", "second-hit", "tinylfu")


def make_admission(kind: str, max_item_bytes: int = 1 << 20) -> AdmissionPolicy:
    if kind == "admit-all":
        return AdmitAll()
    if kind == "size-threshold":
        return SizeThresholdAdmission(max_item_bytes)
    if kind == "second-hit":
        return SecondHitAdmission()
    if kind == "tinylfu":
        return TinyLFUAdmission()
    raise ValueError(f"unknown admission policy {kind!r}; known: {ADMISSION_KINDS}")


# ---------------------------------------------------------------------------
# Memory tier
# ---------------------------------------------------------------------------


class _MemShard:
    __slots__ = ("lock", "lru", "used", "hits", "misses", "evictions",
                 "admitted", "rejected", "bytes_admitted", "bytes_evicted")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.lru: "OrderedDict[str, bytes]" = OrderedDict()
        self.used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admitted = 0
        self.rejected = 0
        self.bytes_admitted = 0
        self.bytes_evicted = 0


class MemoryTierCache:
    """Sharded, lock-striped byte-bounded LRU.  Each shard owns 1/N of the
    capacity and its own lock, so the aggregate can never exceed
    ``capacity_bytes`` while concurrent readers rarely contend.

    Striping tradeoff: the largest cacheable item is ``capacity_bytes //
    shards`` — an object bigger than one shard's budget is rejected (counted
    in ``rejected``) rather than allowed to blow the shard's bound.  Size
    jumbo objects for the disk tier, or use fewer shards when single items
    approach the memory budget."""

    def __init__(
        self,
        capacity_bytes: int,
        *,
        shards: int = 1,
        admission: Optional[AdmissionPolicy] = None,
    ) -> None:
        if shards < 1:
            raise ValueError("shards must be >= 1")
        self.capacity = max(int(capacity_bytes), 0)
        self.admission = admission or AdmitAll()
        self._shards = [_MemShard() for _ in range(shards)]

    def _shard(self, key: str) -> _MemShard:
        if len(self._shards) == 1:
            return self._shards[0]
        h = hashlib.blake2b(key.encode(), digest_size=4).digest()
        return self._shards[int.from_bytes(h, "little") % len(self._shards)]

    def _per_shard_capacity(self) -> int:
        return self.capacity // len(self._shards)

    def get(self, key: str) -> Optional[bytes]:
        sh = self._shard(key)
        with sh.lock:
            data = sh.lru.get(key)
            if data is not None:
                sh.lru.move_to_end(key)
                sh.hits += 1
                return data
            sh.misses += 1
            return None

    def put(self, key: str, data: bytes) -> bool:
        size = len(data)
        sh = self._shard(key)
        if not self.admission.admit(key, size):
            with sh.lock:
                sh.rejected += 1
            return False
        with sh.lock:
            # capacity is read under the shard lock: a concurrent
            # set_capacity shrink must not leave this shard sized (and
            # evicted) against the stale larger budget
            cap = self._per_shard_capacity()
            if size > cap:
                sh.rejected += 1
                return False
            if key in sh.lru:
                sh.lru.move_to_end(key)
                return True
            sh.lru[key] = data
            sh.used += size
            sh.admitted += 1
            sh.bytes_admitted += size
            self._evict_shard_locked(sh, cap)
        return True

    def _evict_shard_locked(self, sh: _MemShard, cap: int) -> None:
        while sh.used > cap and sh.lru:
            _, victim = sh.lru.popitem(last=False)
            sh.used -= len(victim)
            sh.evictions += 1
            sh.bytes_evicted += len(victim)

    def set_capacity(self, capacity_bytes: int) -> int:
        self.capacity = max(int(capacity_bytes), 0)
        cap = self._per_shard_capacity()
        for sh in self._shards:
            with sh.lock:
                self._evict_shard_locked(sh, cap)
        return self.capacity

    @property
    def used_bytes(self) -> int:
        return sum(sh.used for sh in self._shards)

    def stats(self) -> CacheTierStats:
        agg = dict(hits=0, misses=0, evictions=0, admitted=0, rejected=0,
                   bytes_used=0, bytes_admitted=0, bytes_evicted=0)
        for sh in self._shards:
            with sh.lock:
                agg["hits"] += sh.hits
                agg["misses"] += sh.misses
                agg["evictions"] += sh.evictions
                agg["admitted"] += sh.admitted
                agg["rejected"] += sh.rejected
                agg["bytes_used"] += sh.used
                agg["bytes_admitted"] += sh.bytes_admitted
                agg["bytes_evicted"] += sh.bytes_evicted
        return CacheTierStats(**agg)


# ---------------------------------------------------------------------------
# Disk tier
# ---------------------------------------------------------------------------


class _DiskEntry:
    __slots__ = ("size", "final", "read_failures")

    def __init__(self, size: int, final: bool) -> None:
        self.size = size
        self.final = final
        self.read_failures = 0  # consecutive non-ENOENT read errors


class DiskTierCache:
    """Byte-bounded on-disk LRU with atomic writes and pluggable admission.

    Capacity accounting is *reservation-based*: a writer reserves its bytes in
    the index (evicting LRU victims as needed) before touching the disk, so
    the sum of finalized cache files never exceeds ``capacity_bytes`` even
    under parallel writers.  ``capacity_bytes=0`` means unbounded (the legacy
    ``DiskCacheStore`` behaviour).  Same-key writers serialize on a striped
    lock; distinct keys proceed in parallel.

    Multi-host modes (both off by default — single-host behaviour is
    unchanged):

    * ``journal`` — pass a :class:`~repro_torch.core.coord.SharedDiskJournal`: the
      in-process index is replaced by the cross-process byte journal, so N
      writer processes on one shared directory still never overshoot
      ``capacity_bytes`` (the journal's capacity is authoritative).
    * ``shard=(host_id, n_hosts)`` — the keyspace is partitioned with
      :func:`~repro_torch.core.coord.host_shard`; this instance admits and accounts
      only its own shard (``capacity_bytes`` is per-host) while GETs for
      peer-owned keys read the shared directory opportunistically.  File
      names carry the owning shard as a prefix so re-indexing on init never
      adopts a peer's bytes into this host's budget.
    """

    def __init__(
        self,
        cache_dir: str,
        capacity_bytes: int = 0,
        admission: Optional[AdmissionPolicy] = None,
        *,
        write_stripes: int = 16,
        journal: Optional[SharedDiskJournal] = None,
        shard: Optional[Tuple[int, int]] = None,
        tmp_grace_s: float = 120.0,
    ) -> None:
        if journal is not None and shard is not None:
            raise ValueError("journal and shard coordination are exclusive")
        if shard is not None and not 0 <= shard[0] < shard[1]:
            # host_shard() only ever returns 0..n_hosts-1: an out-of-range
            # host id (e.g. 1-based) would silently own NO keys — every put
            # skipped, no disk tier at all, and no error to say so
            raise ValueError(
                f"shard host_id {shard[0]} out of range for {shard[1]} hosts "
                "(host ids are 0-based)"
            )
        self.dir = cache_dir
        self.capacity = max(int(capacity_bytes), 0)
        self.admission = admission or AdmitAll()
        self.journal = journal
        self.shard = shard
        # shard mode: the keyspace slots this instance currently owns.  The
        # static default is exactly {host_id}; elastic membership handoff
        # rewrites it live through reshard().
        self._owned = frozenset({shard[0]}) if shard is not None else frozenset()
        self._owned_prefixes: Tuple[str, ...] = tuple(
            self._shard_prefix(s) for s in sorted(self._owned)
        )
        self.tmp_grace_s = tmp_grace_s
        os.makedirs(cache_dir, exist_ok=True)
        self._index: "OrderedDict[str, _DiskEntry]" = OrderedDict()
        self._used = 0
        self._lock = threading.Lock()  # index + counters
        self._stripes = [threading.Lock() for _ in range(write_stripes)]
        self.orphans_removed = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._admitted = 0
        self._rejected = 0
        self._write_failures = 0
        self._bytes_admitted = 0
        self._bytes_evicted = 0
        self._shard_foreign = 0
        self._recover()

    # -- init / recovery -----------------------------------------------------
    def _recover(self) -> None:
        """Purge orphaned tmp files from crashed writers; re-index surviving
        entries (oldest mtime first, so recovered LRU order is sensible).

        Multi-process tolerance: a *fresh* tmp file (mtime within
        ``tmp_grace_s``) belongs to a live writer in another process — on a
        shared directory, purging it would yank an in-flight write out from
        under a peer — so only stale tmps are treated as crash orphans.  In
        shard mode only files carrying this host's shard prefix are adopted
        (a peer's entries are its budget, not ours); in journal mode the
        directory is reconciled against the shared journal instead of
        rebuilding a private index."""
        now = time.time()
        found = []
        for name in os.listdir(self.dir):
            if name.startswith("."):  # coordination state (.coord), dotfiles
                continue
            path = os.path.join(self.dir, name)
            if ".tmp" in name:
                try:
                    if now - os.stat(path).st_mtime >= self.tmp_grace_s:
                        os.remove(path)
                        self.orphans_removed += 1
                except OSError:
                    pass
                continue
            if self.journal is not None:
                continue  # the journal re-lists under its own lock below
            if self.shard is not None and not self._owns(name):
                continue  # a peer host's entry (or pre-shard debris): not ours
            try:
                st = os.stat(path)
            except OSError:
                continue
            found.append((st.st_mtime, name, st.st_size))
        if self.journal is not None:
            # listing happens inside the journal lock — a pre-lock listing
            # would race live peers and leak their just-finalized bytes
            self.journal.reconcile(capacity_bytes=self.capacity)
            return
        for _, name, size in sorted(found):
            self._index[name] = _DiskEntry(size, True)
            self._used += size
        with self._lock:  # a shrunk capacity still bounds a reload
            paths = self._pop_victims_locked()
        self._unlink(paths)

    # -- key mapping ---------------------------------------------------------
    def _shard_prefix(self, owner: Optional[int] = None) -> str:
        if owner is None:
            owner = self.shard[0]
        return f"s{owner:03d}-"

    def _fname(self, key: str) -> str:
        digest = hashlib.sha1(key.encode()).hexdigest()
        if self.shard is not None:
            return self._shard_prefix(host_shard(key, self.shard[1])) + digest
        return digest

    def _owns(self, fname: str) -> bool:
        return self.shard is None or fname.startswith(self._owned_prefixes)

    def _path(self, fname: str) -> str:
        return os.path.join(self.dir, fname)

    def _stripe(self, fname: str) -> threading.Lock:
        # the trailing 8 chars are always hex digest (shard mode prefixes)
        return self._stripes[int(fname[-8:], 16) % len(self._stripes)]

    # -- eviction ------------------------------------------------------------
    def _pop_victims_locked(self, need: int = 0) -> List[str]:
        """Pop LRU *finalized* entries from the index until ``need`` more
        bytes fit; return their paths for the caller to unlink.  Provisional
        (mid-write) entries are skipped: their file does not exist yet and
        popping them would corrupt the writer's accounting."""
        paths: List[str] = []
        while self.capacity and self._used + need > self.capacity:
            victim = next((f for f, e in self._index.items() if e.final), None)
            if victim is None:
                break
            entry = self._index.pop(victim)
            self._used -= entry.size
            self._evictions += 1
            self._bytes_evicted += entry.size
            paths.append(self._path(victim))
        return paths

    @staticmethod
    def _unlink(paths: List[str]) -> None:
        for p in paths:
            try:
                os.remove(p)
            except OSError:
                pass

    def _evict_locked(self, need: int = 0) -> None:
        """One-item-sized eviction for the get/put hot paths: the unlink
        stays under the lock so the on-disk bytes never exceed the accounted
        bytes (the bound tests scan the directory concurrently).  Bulk
        sweeps (capacity shrink) go through set_capacity, which unlinks
        OUTSIDE the lock."""
        self._unlink(self._pop_victims_locked(need))

    # -- get / put -----------------------------------------------------------
    def _get_journal(self, fname: str) -> Optional[bytes]:
        """Journal-mode GET: the file system is read directly; the shared
        journal only learns about recency (LRU touch) and externally vanished
        entries.  A peer evicting between our open and the touch is benign —
        we still serve the bytes our fd pinned, and touch() on a gone entry
        is a no-op."""
        try:
            with open(self._path(fname), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            self.journal.repair_missing(fname)
            with self._lock:
                self._misses += 1
            return None
        except OSError:
            with self._lock:
                self._misses += 1
            return None
        self.journal.touch(fname)
        with self._lock:
            self._hits += 1
        return data

    def _get_foreign(self, fname: str) -> Optional[bytes]:
        """Shard-mode GET for a key owned by a peer host: opportunistic read
        of the shared directory, no accounting (the bytes live in the owner's
        budget and only the owner maintains LRU order)."""
        try:
            with open(self._path(fname), "rb") as f:
                data = f.read()
        except OSError:
            with self._lock:
                self._misses += 1
            return None
        with self._lock:
            self._hits += 1
        return data

    def _note_hit(self, key: str) -> None:
        """Feed hit-rate-aware admission policies (TinyLFU) the hit stream;
        duck-typed so the stateless policies cost nothing."""
        rec = getattr(self.admission, "record", None)
        if rec is not None:
            rec(key)

    def get(self, key: str) -> Optional[bytes]:
        fname = self._fname(key)
        if self.journal is not None:
            data = self._get_journal(fname)
            if data is not None:
                self._note_hit(key)
            return data
        if not self._owns(fname):
            # a peer host's key: its owner does the admission accounting
            return self._get_foreign(fname)
        try:
            with open(self._path(fname), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            with self._lock:
                entry = self._index.get(fname)
                if (entry is not None and entry.final
                        and not os.path.exists(self._path(fname))):
                    # vanished mid-read (external delete / crash leftover):
                    # repair the byte accounting instead of leaking it.  The
                    # file is looked for again under the lock: between the
                    # failed open and here the key may have been evicted and
                    # written anew, and dropping that entry would leave its
                    # file on disk outside the accounting
                    del self._index[fname]
                    self._used -= entry.size
                self._misses += 1
            return None
        except OSError:
            # transient failure (EMFILE, EACCES, mid-read error): the file
            # may well still exist — count the miss but keep the accounting,
            # or the still-present bytes would become untracked and push
            # real disk usage over capacity.  A PERSISTENTLY unreadable
            # entry must not stay pinned forever though (put()'s dedup
            # fast-path refreshes it to MRU on every origin refill), so
            # after a few consecutive failures drop it and unlink.
            with self._lock:
                self._misses += 1
                entry = self._index.get(fname)
                if entry is not None and entry.final:
                    entry.read_failures += 1
                    if entry.read_failures >= 3:
                        del self._index[fname]
                        self._used -= entry.size
                        try:
                            os.remove(self._path(fname))
                        except OSError:
                            pass
            return None
        with self._lock:
            entry = self._index.get(fname)
            if entry is not None:
                entry.read_failures = 0
                self._index.move_to_end(fname)
            # not indexed: either a concurrent eviction unlinked the file
            # while our fd kept the read alive, or an external process
            # dropped a file in mid-run.  Either way the bytes must NOT be
            # (re-)indexed — adopting a just-evicted name would create a
            # phantom entry whose file is gone, corrupting the accounting
            # and short-circuiting the next put().  Serve the data as a hit
            # and leave the index alone (externally placed files are only
            # adopted by _recover at init).
            self._hits += 1
        self._note_hit(key)
        return data

    def _put_journal(self, fname: str, data: bytes) -> bool:
        """Journal-mode PUT: reserve in the shared journal (which evicts
        victims — possibly a peer's — under its cross-process lock), then
        write tmp + rename, then finalize.  A finalize that comes back False
        means our reservation expired mid-write (writer slower than the
        journal's reserve TTL): the renamed file is no longer accounted for,
        so it must be unlinked rather than become untracked bytes."""
        size = len(data)
        with self._stripe(fname):
            res = self.journal.reserve(fname, size)
            if res.dedup:
                return True
            if not res.ok:
                with self._lock:
                    self._rejected += 1
                return False
            with self._lock:
                self._evictions += res.evicted
                self._bytes_evicted += res.evicted_bytes
            tmp = self._path(fname) + f".tmp{os.getpid()}-{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, self._path(fname))
            except OSError:
                self.journal.abort(fname)
                with self._lock:
                    self._write_failures += 1
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return False
            if not self.journal.finalize(fname):
                self._unlink([self._path(fname)])
                with self._lock:
                    self._write_failures += 1
                return False
            with self._lock:
                self._admitted += 1
                self._bytes_admitted += size
        return True

    def put(self, key: str, data: bytes) -> bool:
        size = len(data)
        fname = self._fname(key)
        if not self._owns(fname):
            with self._lock:
                self._shard_foreign += 1
            return False
        if (self.capacity and size > self.capacity) or not self.admission.admit(key, size):
            with self._lock:
                self._rejected += 1
            return False
        if self.journal is not None:
            return self._put_journal(fname, data)
        with self._stripe(fname):
            with self._lock:
                if fname in self._index:
                    self._index.move_to_end(fname)
                    return True
                if self.capacity:
                    self._evict_locked(need=size)
                    if self._used + size > self.capacity:
                        # only mid-write reservations left to evict
                        self._rejected += 1
                        return False
                self._index[fname] = _DiskEntry(size, False)
                self._used += size
            tmp = self._path(fname) + f".tmp{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, self._path(fname))
            except OSError:
                with self._lock:
                    entry = self._index.pop(fname, None)
                    if entry is not None:
                        self._used -= entry.size
                    self._write_failures += 1  # I/O failure, not a rejection
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return False
            with self._lock:
                entry = self._index.get(fname)
                if entry is not None:
                    entry.final = True
                self._admitted += 1
                self._bytes_admitted += size
        return True

    # -- control / observability ---------------------------------------------
    def set_capacity(self, capacity_bytes: int) -> int:
        """A shrink can evict thousands of entries; victims are popped under
        the lock but unlinked after releasing it, so concurrent get/put
        traffic is not stalled behind the whole deletion sweep.  In journal
        mode the shared journal's capacity is authoritative and the change is
        visible to every process sharing the directory."""
        if self.journal is not None:
            self.capacity = self.journal.set_capacity(capacity_bytes)
            return self.capacity
        with self._lock:
            self.capacity = max(int(capacity_bytes), 0)
            paths = self._pop_victims_locked()
        self._unlink(paths)
        return self.capacity

    def set_admission(self, policy: AdmissionPolicy) -> None:
        self.admission = policy

    def reshard(self, owned_slots) -> Dict[str, int]:
        """Shard-mode elastic handoff: replace the set of keyspace slots
        this host owns (computed fleet-wide from the membership view with
        :func:`repro_torch.core.coord.slot_owners`) without restarting.

        * **released** slots: their entries leave *this index only* — the
          files stay on disk for the slot's new owner to adopt (unlinking
          them would throw away a warm cache the fleet still wants), and
          this host's budget is freed immediately;
        * **gained** slots: their on-disk files are adopted at the LRU cold
          end in mtime order (the same rule ``_recover`` uses), then the
          index is evicted down to ``capacity_bytes`` — so the per-host
          byte bound holds through the handoff at every instant.

        Provisional (mid-write) entries of released slots are kept until
        their writer finishes; the next reshard or eviction retires them.
        Returns ``{"dropped": n, "adopted": n}``."""
        if self.shard is None:
            raise ValueError("reshard() requires shard mode")
        owned = frozenset(int(s) for s in owned_slots)
        for s in owned:
            if not 0 <= s < self.shard[1]:
                raise ValueError(
                    f"slot {s} out of range for {self.shard[1]} shard slots"
                )
        dropped = adopted = 0
        with self._lock:
            gained = owned - self._owned
            self._owned = owned
            self._owned_prefixes = tuple(
                self._shard_prefix(s) for s in sorted(owned)
            )
            for fname in [f for f in self._index if not self._owns(f)]:
                entry = self._index[fname]
                if not entry.final:
                    continue  # a live writer still owns this reservation
                del self._index[fname]
                self._used -= entry.size
                dropped += 1
            if gained:
                prefixes = tuple(self._shard_prefix(s) for s in sorted(gained))
                found = []
                for name in os.listdir(self.dir):
                    if name.startswith(".") or ".tmp" in name:
                        continue
                    if not name.startswith(prefixes) or name in self._index:
                        continue
                    try:
                        st = os.stat(self._path(name))
                    except OSError:
                        continue
                    found.append((st.st_mtime, name, st.st_size))
                # newest-first insertion at the front leaves the oldest
                # adoptee coldest, matching _recover's mtime LRU order
                for _, name, size in sorted(found, reverse=True):
                    self._index[name] = _DiskEntry(size, True)
                    self._index.move_to_end(name, last=False)
                    self._used += size
                    adopted += 1
            paths = self._pop_victims_locked()
        self._unlink(paths)
        return {"dropped": dropped, "adopted": adopted}

    @property
    def used_bytes(self) -> int:
        if self.journal is not None:
            return self.journal.used_bytes()
        with self._lock:
            return self._used

    def stats(self) -> CacheTierStats:
        """Per-process counters; ``bytes_used`` is the tier-wide figure in
        journal mode (each process's hit/miss/eviction counts describe its
        own operations, which is what stays meaningful under contention)."""
        bytes_used = (
            self.journal.used_bytes() if self.journal is not None else None
        )
        with self._lock:
            return CacheTierStats(
                hits=self._hits,
                misses=self._misses,
                evictions=self._evictions,
                admitted=self._admitted,
                rejected=self._rejected,
                write_failures=self._write_failures,
                bytes_used=self._used if bytes_used is None else bytes_used,
                bytes_admitted=self._bytes_admitted,
                bytes_evicted=self._bytes_evicted,
                shard_foreign=self._shard_foreign,
            )


# ---------------------------------------------------------------------------
# Tiered facade
# ---------------------------------------------------------------------------


class TieredCacheStore:
    """Memory LRU over a bounded disk tier over the origin store.

    Implements the :class:`repro_torch.data.store.ObjectStore` protocol (registered
    as a virtual subclass by ``repro_torch.data.store`` to avoid a circular import).
    Disk hits are promoted to memory; origin fetches are written through both
    tiers.  Each GET records a ``cache_get`` tracing span tagged with the
    serving tier, so hit/miss/byte composition is visible in the same
    Perfetto timeline / ``window_summary`` pipeline as the loader stages.
    """

    ADMISSION_KINDS = ADMISSION_KINDS

    def __init__(
        self,
        base,
        *,
        memory: Optional[MemoryTierCache] = None,
        disk: Optional[DiskTierCache] = None,
        tracer: Tracer = NULL_TRACER,
        admission_max_item_bytes: int = 1 << 20,
    ) -> None:
        if memory is None and disk is None:
            raise ValueError("TieredCacheStore needs at least one tier")
        self.base = base
        self.memory = memory
        self.disk = disk
        self.tracer = tracer
        self.admission_max_item_bytes = admission_max_item_bytes
        # policies are memoized per index so stateful ones (second-hit's
        # Bloom filter) survive autotune probe/revert toggles instead of
        # being reset to empty on every knob move
        self._admission_by_index: dict = {}
        if disk is not None:
            self._admission_by_index[self.admission_index()] = disk.admission

    # -- trace helper --------------------------------------------------------
    def _trace(self, t0: float, tier: str, nbytes: int) -> None:
        self.tracer.record(CACHE_GET, t0, time.monotonic(), tier=tier, nbytes=nbytes)

    # -- ObjectStore surface -------------------------------------------------
    def get(self, key: str) -> bytes:
        t0 = time.monotonic()
        if self.memory is not None:
            data = self.memory.get(key)
            if data is not None:
                self._trace(t0, "memory", len(data))
                return data
        if self.disk is not None:
            data = self.disk.get(key)
            if data is not None:
                if self.memory is not None:
                    self.memory.put(key, data)
                self._trace(t0, "disk", len(data))
                return data
        data = self.base.get(key)
        if self.disk is not None:
            self.disk.put(key, data)
        if self.memory is not None:
            self.memory.put(key, data)
        self._trace(t0, "origin", len(data))
        return data

    def lookup(self, key: str) -> Optional[Tuple[bytes, str]]:
        """Cache-tier-only probe: ``(data, tier)`` on a memory/disk hit
        (promoting disk hits exactly like :meth:`get`), ``None`` on a miss —
        never touches the origin.  The serving read path uses this to decide
        which requests enter single-flight coalescing / tenant metering:
        only true misses pay for a backend fetch."""
        t0 = time.monotonic()
        if self.memory is not None:
            data = self.memory.get(key)
            if data is not None:
                self._trace(t0, "memory", len(data))
                return data, "memory"
        if self.disk is not None:
            data = self.disk.get(key)
            if data is not None:
                if self.memory is not None:
                    self.memory.put(key, data)
                self._trace(t0, "disk", len(data))
                return data, "disk"
        return None

    async def aget(self, key: str) -> bytes:
        """Async-safe GET: memory is O(1) inline, disk I/O runs on the
        default executor, the origin uses its own ``aget``."""
        t0 = time.monotonic()
        if self.memory is not None:
            data = self.memory.get(key)
            if data is not None:
                self._trace(t0, "memory", len(data))
                return data
        loop = asyncio.get_running_loop()
        if self.disk is not None:
            data = await loop.run_in_executor(None, self.disk.get, key)
            if data is not None:
                if self.memory is not None:
                    self.memory.put(key, data)
                self._trace(t0, "disk", len(data))
                return data
        data = await self.base.aget(key)
        if self.disk is not None:
            await loop.run_in_executor(None, self.disk.put, key, data)
        if self.memory is not None:
            self.memory.put(key, data)
        self._trace(t0, "origin", len(data))
        return data

    def put(self, key: str, data: bytes) -> None:
        self.base.put(key, data)

    def list_keys(self, prefix: str = "") -> List[str]:
        return self.base.list_keys(prefix)

    def size(self, key: str) -> int:
        return self.base.size(key)

    def close(self) -> None:
        self.base.close()

    # -- unified stats -------------------------------------------------------
    def cache_stats(self) -> dict:
        """Snapshot of every tier (named ``cache_stats`` so the autotuner's
        store-stack walk still finds ``SimulatedS3Store.stats`` underneath)."""
        out = {}
        if self.memory is not None:
            out["memory"] = self.memory.stats()
        if self.disk is not None:
            out["disk"] = self.disk.stats()
        return out

    @property
    def hit_rate(self) -> float:
        """Fraction of external GETs served by *any* tier."""
        outer = self.memory if self.memory is not None else self.disk
        total = outer.stats().lookups
        if not total:
            return 0.0
        inner = self.disk if self.disk is not None else self.memory
        origin_fetches = inner.stats().misses
        return (total - origin_fetches) / total

    # -- autotune knob surfaces ----------------------------------------------
    def set_memory_capacity(self, capacity_bytes: int) -> int:
        if self.memory is None:
            return 0
        return self.memory.set_capacity(capacity_bytes)

    def set_disk_capacity(self, capacity_bytes: int) -> int:
        if self.disk is None:
            return 0
        return self.disk.set_capacity(capacity_bytes)

    def admission_index(self) -> int:
        if self.disk is None:
            return 0
        try:
            return ADMISSION_KINDS.index(self.disk.admission.name)
        except ValueError:
            return 0

    def set_admission(self, index: int) -> int:
        if self.disk is None:
            return 0
        index = max(0, min(int(index), len(ADMISSION_KINDS) - 1))
        if index not in self._admission_by_index:
            self._admission_by_index[index] = make_admission(
                ADMISSION_KINDS[index], self.admission_max_item_bytes
            )
        self.disk.set_admission(self._admission_by_index[index])
        return index


# ---------------------------------------------------------------------------
# Legacy shims (public names re-exported by repro_torch.data.store)
# ---------------------------------------------------------------------------


class CachedStore(TieredCacheStore):
    """Single-tier in-memory LRU — the original ``CachedStore`` surface
    (exact global LRU via one shard; ``hits``/``misses``/``hit_rate``)."""

    def __init__(self, base, capacity_bytes: int) -> None:
        super().__init__(base, memory=MemoryTierCache(capacity_bytes, shards=1))

    @property
    def capacity(self) -> int:
        return self.memory.capacity

    @property
    def hits(self) -> int:
        return self.memory.stats().hits

    @property
    def misses(self) -> int:
        return self.memory.stats().misses

    @property
    def _used(self) -> int:
        return self.memory.used_bytes


class DiskCacheStore(TieredCacheStore):
    """Single-tier on-disk cache — the original ``DiskCacheStore`` surface,
    now with optional byte bound + admission (0 = unbounded, as before)."""

    def __init__(
        self,
        base,
        cache_dir: str,
        capacity_bytes: int = 0,
        admission: Optional[AdmissionPolicy] = None,
    ) -> None:
        super().__init__(
            base, disk=DiskTierCache(cache_dir, capacity_bytes, admission)
        )

    @property
    def hits(self) -> int:
        return self.disk.stats().hits

    @property
    def misses(self) -> int:
        return self.disk.stats().misses
