"""File-based multi-host coordination: locks, leases, counters, journals.

The ROADMAP's production fleet puts many loader hosts behind one NIC and one
shared disk.  Without coordination two failure modes appear (the
uncoordinated-client collapse that arXiv:2503.22643 and the Uber distributed
pipeline design against):

* every host's :class:`~repro_torch.data.cache.DiskTierCache` accounts bytes with
  in-process locks only, so N writers on one shared directory overshoot
  ``capacity_bytes`` by up to N times;
* every host's :class:`~repro_torch.core.autotune.AutotuneController` sees the same
  saturated NIC and raises fetch concurrency at the same time, which is
  exactly how the link got saturated in the first place.

This module is the shared substrate both clients build on.  It deliberately
needs **no network daemon**: coordination state is lock files + small JSON
records under a directory every host can reach (the shared disk itself, or
any NFS-style mount).  Primitives:

* :class:`FileLock`       — ``fcntl.flock``-based inter-process mutex.
* :func:`host_shard`      — stable key -> host assignment for partitioned
  (rather than shared-accounting) cache keyspaces.
* :class:`SharedCounter`  — cross-process integer with atomic add (used by
  the simulated store to model one NIC shared by several processes).
* :class:`AppendLog`      — the shared-state substrate: an fcntl-locked
  append-only record log with snapshot compaction, crash-safe torn-tail
  recovery and bounded replay.  Every board below is a reducer over it.
* :class:`SharedDiskJournal` — byte-accounting journal behind the shared
  disk tier (reservation-based capacity, LRU eviction, crash recovery),
  reimplemented on :class:`AppendLog` so a mutation appends ~100 bytes
  instead of rewriting the whole index (:class:`JsonDiskJournal` keeps the
  legacy rewrite-per-mutation implementation for comparison/migration).
* :class:`UpProbeLease`   — a TTL lease on the "may increase concurrency /
  hedging" token consumed by the autotuner, plus an append-only event log so
  benchmarks can audit that at most one host ever held it at a time.
* :class:`MembershipBoard` — heartbeat-lease fleet membership: expiry is
  departure, joins/leaves bump a generation, and a dead member's other
  leases (up-probe token, shard claims) become immediately reapable.
* :class:`CongestionBoard` — AIMD down-shedding: a host observing collapse
  posts a shed event; every controller polling the board multiplicatively
  volunteers concurrency back and recovers additively.
* :class:`EpochShardBoard` — elastic work claiming: an epoch's batch space
  is split into contiguous shards claimed under TTL leases with a
  done-through progress cursor, so a joining host picks up work and a dead
  host's shard is resumed mid-shard by a survivor.

The port keeps the reference's on-disk formats byte for byte (lock files,
append-log segments and records, journal snapshots, the boards' records
and audit logs), so a directory written by either package is read by the
other, and a fleet may mix the two.  The module imports no ``torch``: the
cache tiers, the elastic sampler and spawned coordination processes use it.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

try:  # pragma: no cover - exercised only on non-POSIX platforms
    import fcntl

    HAVE_FCNTL = True
except ImportError:  # pragma: no cover
    fcntl = None  # type: ignore[assignment]
    HAVE_FCNTL = False


class CoordinationUnavailable(RuntimeError):
    """Raised when file-based coordination is requested on a platform
    without ``fcntl`` advisory locks."""


def default_owner() -> str:
    """Stable-enough identity for lease records: host + pid."""
    return f"{socket.gethostname()}-{os.getpid()}"


# ---------------------------------------------------------------------------
# Lock file
# ---------------------------------------------------------------------------


class FileLock:
    """Inter-process exclusive lock (``flock``) usable as a context manager.

    ``flock`` locks belong to the open file description, so every acquisition
    opens a fresh fd — two threads of one process exclude each other exactly
    like two processes do.  The lock file itself carries no data and is never
    deleted (unlinking a locked path races fresh openers on some kernels).
    ``flock`` (not POSIX ``fcntl`` byte locks) also survives an unrelated
    close of the same file elsewhere in the process — the lock-on-close
    hazard ``scripts/check_lock_semantics.py`` probes for.
    """

    def __init__(self, path: str) -> None:
        if not HAVE_FCNTL:
            raise CoordinationUnavailable(
                "repro_torch.core.coord requires fcntl advisory locks"
            )
        self.path = path
        self._local = threading.local()

    def __enter__(self) -> "FileLock":
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
        except BaseException:
            os.close(fd)
            raise
        self._local.fd = fd
        return self

    def __exit__(self, *exc) -> None:
        fd = self._local.fd
        self._local.fd = None
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)


# ---------------------------------------------------------------------------
# Key sharding
# ---------------------------------------------------------------------------


def host_shard(key: str, n_hosts: int) -> int:
    """Stable assignment of ``key`` to one of ``n_hosts`` (blake2b-derived,
    independent of Python's randomized ``hash``).  Hosts that partition the
    cache keyspace instead of sharing one accounting journal each own the
    keys where ``host_shard(key, n) == host_id``."""
    if n_hosts <= 1:
        return 0
    h = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % n_hosts


def slot_owners(members: Sequence[str], n_slots: int) -> Dict[int, str]:
    """Deterministic slot -> member assignment for elastic shard handoff:
    sorted members take slots round-robin, so every host computes the same
    map from the same membership view without any extra coordination.  With
    a fixed ``n_slots`` (= the :func:`host_shard` modulus), a membership
    change moves only the slots whose round-robin owner changed."""
    ms = sorted(members)
    if not ms:
        return {}
    return {s: ms[s % len(ms)] for s in range(int(n_slots))}


# ---------------------------------------------------------------------------
# Shared counter
# ---------------------------------------------------------------------------


class SharedCounter:
    """Cross-process integer with atomic add (text file under a FileLock).

    Used to model shared physical resources in benchmarks — e.g. the number
    of in-flight transfers on one NIC serving several loader processes.  A
    process killed between add(+1) and add(-1) leaks its increment; callers
    that need self-healing should reset the counter at fleet start."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = FileLock(path + ".lock")

    def _read(self) -> int:
        try:
            with open(self.path, "r") as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    def add(self, delta: int) -> int:
        with self._lock:
            val = self._read() + delta
            tmp = f"{self.path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(str(val))
            os.replace(tmp, self.path)
            return val

    def value(self) -> int:
        with self._lock:
            return self._read()


# ---------------------------------------------------------------------------
# Append-log substrate
# ---------------------------------------------------------------------------


def _dump_records(records: List[Dict[str, Any]]) -> bytes:
    return "".join(
        json.dumps(r, separators=(",", ":")) + "\n" for r in records
    ).encode()


class AppendLog:
    """fcntl-locked append-only record log with snapshot compaction.

    The shared-state substrate every coordination board builds on: state is
    a reducer over an ordered stream of small JSON records, so a mutation
    appends ~100 bytes instead of rewriting the whole document.  Layout
    (all under ``dir``):

    * ``{name}.gen``            — current segment generation (atomic
      ``os.replace`` pointer; the ONLY authority on which segment is live)
    * ``{name}.seg{G:08d}.log`` — generation G's records, one JSON object
      per line; the segment starts with the snapshot of the state at
      compaction time
    * ``{name}.lock``           — the flock every read-modify-write holds

    Caller supplies the reducer: ``make_state()`` builds an empty state,
    ``apply(state, rec)`` folds one record in (must be pure state — side
    effects like unlinking files belong in the mutator, never in replay),
    and ``snapshot(state)`` emits records that rebuild the state through
    the same ``apply`` (determinism: replay and live mutation share one
    code path).

    Per-process bounded replay: each instance caches (generation, byte
    offset, materialized state); under the lock it re-reads the generation
    pointer and replays only the records appended since — O(new records),
    not O(log).  Crash safety:

    * a writer killed mid-append leaves an unterminated (or unparseable)
      last line; the next reader truncates that torn tail under the
      exclusive lock — safe because a record is only acknowledged once its
      full line (newline included) is on disk before the lock is released;
    * compaction writes + fsyncs the NEW segment fully before atomically
      bumping the generation pointer, so a crash on either side of the
      bump leaves a consistent log (an orphaned new segment is overwritten
      by the next compaction to that generation; an orphaned old segment
      is swept later).

    ``compact_every`` bounds both segment growth and worst-case replay; a
    fresh process replays at most one snapshot + ``compact_every`` records.
    """

    def __init__(
        self,
        dir: str,
        name: str,
        *,
        make_state: Callable[[], Any],
        apply: Callable[[Any, Dict[str, Any]], None],
        snapshot: Callable[[Any], List[Dict[str, Any]]],
        compact_every: int = 1024,
        bootstrap: Optional[Callable[[], List[Dict[str, Any]]]] = None,
        post_bootstrap: Optional[Callable[[], None]] = None,
    ) -> None:
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self.name = name
        self._make_state = make_state
        self._apply = apply
        self._snapshot = snapshot
        self._bootstrap = bootstrap
        self._post_bootstrap = post_bootstrap
        self.compact_every = max(int(compact_every), 0)
        self.gen_path = os.path.join(dir, f"{name}.gen")
        self._lock = FileLock(os.path.join(dir, f"{name}.lock"))
        self._gen = -1
        self._offset = 0
        self._since_snap = 0
        self._state: Any = None
        # observability + tests: records folded in by this process's syncs
        self.replayed_records = 0
        self.compactions = 0
        self.torn_tails_recovered = 0
        # fault-injection points for crash-during-compaction tests:
        # {"after_seg": fn, "after_gen": fn} called mid-compaction
        self._crash_hooks: Dict[str, Callable[[], None]] = {}

    # -- paths ---------------------------------------------------------------
    def _seg_path(self, gen: int) -> str:
        return os.path.join(self.dir, f"{self.name}.seg{gen:08d}.log")

    # -- generation pointer (only under the flock) ---------------------------
    def _read_gen(self) -> Optional[int]:
        try:
            with open(self.gen_path, "r") as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return None

    def _write_gen(self, gen: int) -> None:
        tmp = f"{self.gen_path}.tmp{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(str(gen))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.gen_path)

    # -- init / sync (only under the flock) ----------------------------------
    def _init_locked(self) -> None:
        """First opener bootstraps generation 0: fold the bootstrap records
        (e.g. a legacy JSON index being migrated) into a fresh state and
        write its snapshot as the gen-0 segment.  The segment is complete
        and fsynced before the generation pointer exists, so a crash mid-
        bootstrap leaves nothing (the next opener bootstraps again)."""
        state = self._make_state()
        for rec in self._bootstrap() if self._bootstrap is not None else []:
            self._apply(state, rec)
        data = _dump_records(self._snapshot(state))
        with open(self._seg_path(0), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        self._write_gen(0)
        if self._post_bootstrap is not None:
            self._post_bootstrap()
        self._gen = 0
        self._offset = len(data)
        self._since_snap = 0
        self._state = state

    def _sync_locked(self) -> None:
        """Bring the cached state up to the log's tip: re-read the generation
        pointer (full replay of the new segment if it moved), then fold in
        records appended past the cached offset, truncating a torn tail."""
        gen = self._read_gen()
        if gen is None:
            self._init_locked()
            return
        if gen != self._gen or self._state is None:
            self._gen = gen
            self._offset = 0
            self._since_snap = 0
            self._state = self._make_state()
        path = self._seg_path(gen)
        try:
            with open(path, "rb") as f:
                f.seek(self._offset)
                buf = f.read()
        except FileNotFoundError:
            # a compactor crashed after bumping the generation but its new
            # segment write never became visible?  Cannot happen with the
            # write-then-fsync-then-bump order; an absent segment means the
            # log was externally deleted — rebuild empty rather than crash
            buf = b""
            with open(path, "wb"):
                pass
        consumed = 0
        while True:
            nl = buf.find(b"\n", consumed)
            if nl < 0:
                if consumed < len(buf):
                    # torn tail from a crashed writer: the record was never
                    # acknowledged (its writer died holding the lock), so
                    # truncating it under this exclusive lock is always safe
                    with open(path, "r+b") as f:
                        f.truncate(self._offset + consumed)
                    self.torn_tails_recovered += 1
                break
            line = buf[consumed:nl]
            if line.strip():
                try:
                    rec = json.loads(line)
                except ValueError:
                    with open(path, "r+b") as f:
                        f.truncate(self._offset + consumed)
                    self.torn_tails_recovered += 1
                    break
                self._apply(self._state, rec)
                self._since_snap += 1
                self.replayed_records += 1
            consumed = nl + 1
        self._offset += consumed

    # -- compaction (only under the flock) -----------------------------------
    def _compact_locked(self) -> None:
        new_gen = self._gen + 1
        data = _dump_records(self._snapshot(self._state))
        new_path = self._seg_path(new_gen)
        # "wb": a compactor that crashed after writing this segment but
        # before bumping the pointer left an orphan here — overwrite it
        with open(new_path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        hook = self._crash_hooks.get("after_seg")
        if hook is not None:
            hook()
        old_path = self._seg_path(self._gen)
        self._write_gen(new_gen)
        hook = self._crash_hooks.get("after_gen")
        if hook is not None:
            hook()
        try:
            os.remove(old_path)
        except OSError:
            pass
        # sweep orphan segments from compactors that crashed between the
        # pointer bump and their unlink
        prefix = f"{self.name}.seg"
        try:
            for nm in os.listdir(self.dir):
                if (
                    nm.startswith(prefix)
                    and nm.endswith(".log")
                    and nm != os.path.basename(new_path)
                ):
                    try:
                        if int(nm[len(prefix):-4]) < new_gen:
                            os.remove(os.path.join(self.dir, nm))
                    except (ValueError, OSError):
                        pass
        except OSError:
            pass
        self._gen = new_gen
        self._offset = len(data)
        self._since_snap = 0
        self.compactions += 1

    # -- surface -------------------------------------------------------------
    @contextmanager
    def update(self) -> Iterator[Tuple[Any, Callable[[Dict[str, Any]], None]]]:
        """Read-modify-write transaction: yields ``(state, emit)``.  The
        caller reads the synced state and calls ``emit(record)`` for each
        mutation — the record is applied to the state immediately (so later
        logic in the same transaction sees it) and appended to the segment,
        in order, before the lock is released.  An exception inside the
        block discards the cached state (it may have diverged from what
        reached disk) and re-raises."""
        with self._lock:
            self._sync_locked()
            pending: List[Dict[str, Any]] = []

            def emit(rec: Dict[str, Any]) -> None:
                self._apply(self._state, rec)
                pending.append(rec)

            try:
                yield self._state, emit
            except BaseException:
                self._state = None  # force a clean resync next time
                raise
            if pending:
                data = _dump_records(pending)
                with open(self._seg_path(self._gen), "ab") as f:
                    f.write(data)
                self._offset += len(data)
                self._since_snap += len(pending)
                if self.compact_every and self._since_snap >= self.compact_every:
                    self._compact_locked()

    @contextmanager
    def view(self) -> Iterator[Any]:
        """Read-only transaction: yields the synced state (do not mutate)."""
        with self._lock:
            self._sync_locked()
            yield self._state

    def compact(self) -> None:
        """Force a compaction now (tests / maintenance)."""
        with self._lock:
            self._sync_locked()
            self._compact_locked()


# ---------------------------------------------------------------------------
# Shared disk-tier journal
# ---------------------------------------------------------------------------


@dataclass
class ReserveResult:
    ok: bool = False
    dedup: bool = False  # key already present (or mid-write by a peer)
    evicted: int = 0
    evicted_bytes: int = 0


@dataclass
class _JEntry:
    fname: str
    size: int
    final: bool
    deadline: float  # provisional reservations expire (crashed writers)


class _JState:
    """Journal reducer state: entries in LRU order (oldest first) plus the
    authoritative capacity and a running byte total."""

    __slots__ = ("entries", "capacity", "used")

    def __init__(self, capacity: int = 0) -> None:
        self.entries: "Dict[str, _JEntry]" = {}
        self.capacity = capacity
        self.used = 0


def _journal_apply(st: _JState, rec: Dict[str, Any]) -> None:
    op = rec.get("op")
    if op == "res":
        f = rec["f"]
        old = st.entries.pop(f, None)
        if old is not None:
            st.used -= old.size
        st.entries[f] = _JEntry(f, int(rec["s"]), False, float(rec["d"]))
        st.used += int(rec["s"])
    elif op == "fin":
        e = st.entries.get(rec["f"])
        if e is not None:
            e.final = True
            e.deadline = 0.0
    elif op == "del":
        e = st.entries.pop(rec["f"], None)
        if e is not None:
            st.used -= e.size
    elif op == "touch":
        e = st.entries.pop(rec["f"], None)
        if e is not None:
            st.entries[rec["f"]] = e  # move to MRU end
    elif op == "cap":
        st.capacity = max(int(rec["c"]), 0)
    elif op == "snap":
        st.entries.clear()
        st.capacity = max(int(rec.get("cap", 0)), 0)
        st.used = 0
        for f, s, final, d in rec.get("e", []):
            st.entries[f] = _JEntry(f, int(s), bool(final), float(d))
            st.used += int(s)


def _journal_snapshot(st: _JState) -> List[Dict[str, Any]]:
    return [
        {
            "op": "snap",
            "cap": st.capacity,
            "e": [
                [e.fname, e.size, e.final, e.deadline]
                for e in st.entries.values()
            ],
        }
    ]


class SharedDiskJournal:
    """Byte-accounting index for a :class:`DiskTierCache` directory shared by
    several processes/hosts, on the :class:`AppendLog` substrate.

    The journal state is the *authoritative* index: every reserve/finalize/
    touch/evict is a read-modify-write under one ``flock``, so the sum of
    reserved bytes — and therefore the bytes on disk, since writers reserve
    before writing and victims are unlinked inside the lock — can never
    exceed ``capacity_bytes`` no matter how many writers race.  Crashed
    writers leak only a provisional reservation, which expires after
    ``reserve_ttl_s`` and becomes evictable.

    A mutation appends one ~100-byte record instead of rewriting the whole
    index document (the :class:`JsonDiskJournal` behaviour this class
    replaced — untenable at millions of tiny entries); a legacy
    ``index.json`` found at first open is migrated into the gen-0 snapshot
    and renamed ``index.json.migrated``.
    """

    COORD_SUBDIR = ".coord"

    def __init__(
        self,
        cache_dir: str,
        capacity_bytes: int = 0,
        *,
        reserve_ttl_s: float = 60.0,
        compact_every: int = 1024,
    ) -> None:
        self.cache_dir = cache_dir
        self.coord_dir = os.path.join(cache_dir, self.COORD_SUBDIR)
        os.makedirs(self.coord_dir, exist_ok=True)
        self.capacity = max(int(capacity_bytes), 0)
        self.reserve_ttl_s = reserve_ttl_s
        # legacy rewrite-per-mutation document (migrated at first open)
        self.index_path = os.path.join(self.coord_dir, "index.json")
        self._log = AppendLog(
            self.coord_dir,
            "journal",
            make_state=lambda: _JState(self.capacity),
            apply=_journal_apply,
            snapshot=_journal_snapshot,
            compact_every=compact_every,
            bootstrap=self._bootstrap_legacy,
            post_bootstrap=self._retire_legacy,
        )

    # -- legacy JSON-index migration -----------------------------------------
    def _bootstrap_legacy(self) -> List[Dict[str, Any]]:
        try:
            with open(self.index_path, "r") as f:
                doc = json.load(f)
        except (FileNotFoundError, ValueError):
            return []
        return [
            {
                "op": "snap",
                "cap": int(doc.get("capacity", self.capacity)),
                "e": [list(e) for e in doc.get("entries", [])],
            }
        ]

    def _retire_legacy(self) -> None:
        try:
            os.replace(self.index_path, self.index_path + ".migrated")
        except OSError:
            pass

    # -- eviction (under lock) -----------------------------------------------
    def _evict_until_fits(
        self, st: _JState, emit: Callable[[Dict[str, Any]], None], need: int
    ) -> Tuple[Optional[int], int]:
        """Evict LRU entries until ``need`` more bytes fit; unlink the
        victims' files while still holding the lock (a concurrent directory
        scan must never observe more bytes than the journal accounts for).
        Returns (count or None when impossible, bytes)."""
        if not st.capacity:
            return 0, 0
        now = time.time()
        victims: List[_JEntry] = []
        while st.used + need > st.capacity:
            victim = next(
                (
                    e
                    for e in st.entries.values()
                    if e.final or e.deadline < now
                ),
                None,
            )
            if victim is None:  # only live mid-write reservations remain
                return None, 0
            # unlink BEFORE the record is appended: a crash between the two
            # leaves the journal still accounting a vanished file (healed by
            # repair_missing/reconcile) rather than unaccounted bytes on
            # disk violating the fleet bound
            try:
                os.remove(os.path.join(self.cache_dir, victim.fname))
            except OSError:
                pass
            if not victim.final:
                self._reclaim_tmps(victim.fname)
            emit({"op": "del", "f": victim.fname})
            victims.append(victim)
        return len(victims), sum(v.size for v in victims)

    def _reclaim_tmps(self, fname: str) -> None:
        """An EXPIRED provisional entry may belong to a writer that stalled
        after writing its tmp file: freeing the journal budget while those
        bytes sit on disk would let the fleet overshoot capacity, so the
        tmp(s) are reclaimed with the reservation.  If the writer ever
        wakes, its finalize() fails and it cleans up after itself."""
        prefix = fname + ".tmp"
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            return
        for name in names:
            if name.startswith(prefix):
                try:
                    os.remove(os.path.join(self.cache_dir, name))
                except OSError:
                    pass

    # -- operations ----------------------------------------------------------
    def reserve(self, fname: str, size: int) -> ReserveResult:
        with self._log.update() as (st, emit):
            self.capacity = st.capacity
            now = time.time()
            e = st.entries.get(fname)
            if e is not None:
                if not e.final and e.deadline < now:
                    # expired reservation of a crashed writer: treating it
                    # as a dedup hit would return True without a file ever
                    # existing, permanently blocking this key — drop it
                    # (and any stalled tmp bytes) and reserve afresh
                    self._reclaim_tmps(fname)
                    emit({"op": "del", "f": fname})
                else:
                    emit({"op": "touch", "f": fname})  # MRU
                    return ReserveResult(ok=True, dedup=True)
            if st.capacity and size > st.capacity:
                return ReserveResult(ok=False)
            n, nbytes = self._evict_until_fits(st, emit, size)
            if n is None:
                return ReserveResult(ok=False)
            emit(
                {
                    "op": "res",
                    "f": fname,
                    "s": int(size),
                    "d": time.time() + self.reserve_ttl_s,
                }
            )
            return ReserveResult(ok=True, evicted=n, evicted_bytes=nbytes)

    def finalize(self, fname: str) -> bool:
        """Mark a reservation durable.  Returns False when the reservation
        expired and was evicted while the (too-slow) writer was writing — the
        caller must unlink its file, which is no longer accounted for."""
        with self._log.update() as (st, emit):
            self.capacity = st.capacity
            if fname in st.entries:
                emit({"op": "fin", "f": fname})
                return True
        return False

    def abort(self, fname: str) -> None:
        with self._log.update() as (st, emit):
            self.capacity = st.capacity
            e = st.entries.get(fname)
            if e is not None and not e.final:
                emit({"op": "del", "f": fname})

    def touch(self, fname: str) -> None:
        with self._log.update() as (st, emit):
            self.capacity = st.capacity
            e = st.entries.get(fname)
            if e is not None and e.final:
                emit({"op": "touch", "f": fname})

    def repair_missing(self, fname: str) -> int:
        """Drop a finalized entry whose file vanished externally; returns the
        repaired byte count (0 when the journal was already consistent — e.g.
        a peer evicted the entry between our read and this call).  The
        absence is re-verified under the lock: between our failed read and
        this call a peer may have evicted AND re-written the key, and
        dropping the fresh entry would leave its file as untracked bytes."""
        with self._log.update() as (st, emit):
            self.capacity = st.capacity
            e = st.entries.get(fname)
            if e is not None and e.final:
                if os.path.exists(os.path.join(self.cache_dir, fname)):
                    return 0  # a peer re-created it: nothing to repair
                emit({"op": "del", "f": fname})
                return e.size
        return 0

    def reconcile(
        self,
        capacity_bytes: Optional[int] = None,
        file_filter: Optional[Callable[[str], bool]] = None,
    ) -> int:
        """Bring the journal and the directory into agreement at init:

        * finalized entries whose file vanished are dropped,
        * expired provisional reservations are dropped,
        * files unknown to the journal (a pre-coordination cache dir, or an
          external drop-in) are adopted at the LRU *cold* end in mtime order,
        * the result is evicted down to capacity.

        The directory is listed while HOLDING the journal lock: a listing
        taken before the lock races live peers — an entry finalized between
        the stale listing and the lock would be dropped as "vanished" while
        its file stays on disk, permanently leaking unaccounted bytes.
        ``file_filter`` lets the caller exclude extra names (tmp files and
        dotfiles are always excluded).  Concurrent reconciles from several
        starting processes serialize on the flock and are idempotent.
        Returns the number of adopted files."""
        with self._log.update() as (st, emit):
            if capacity_bytes is not None:
                cap = max(int(capacity_bytes), 0)
                if cap != st.capacity:
                    emit({"op": "cap", "c": cap})
            self.capacity = st.capacity
            files: Dict[str, Tuple[int, float]] = {}
            for name in os.listdir(self.cache_dir):
                if name.startswith(".") or ".tmp" in name:
                    continue
                if file_filter is not None and not file_filter(name):
                    continue
                try:
                    st_ = os.stat(os.path.join(self.cache_dir, name))
                except OSError:
                    continue
                files[name] = (st_.st_size, st_.st_mtime)
            now = time.time()
            for e in list(st.entries.values()):
                if e.final:
                    if e.fname not in files:
                        emit({"op": "del", "f": e.fname})
                elif e.deadline < now:
                    emit({"op": "del", "f": e.fname})
                # else: a live peer is mid-write — trust it
            known = set(st.entries)
            fresh = sorted(
                (mtime, fname, size)
                for fname, (size, mtime) in files.items()
                if fname not in known
            )
            # adoptees land at the LRU *cold* end: re-snapshot with them
            # first, then the surviving entries in their existing order
            if fresh:
                snap = {
                    "op": "snap",
                    "cap": st.capacity,
                    "e": (
                        [[f, s, True, 0.0] for _, f, s in fresh]
                        + [
                            [e.fname, e.size, e.final, e.deadline]
                            for e in st.entries.values()
                        ]
                    ),
                }
                emit(snap)
            self._evict_until_fits(st, emit, 0)
            return len(fresh)

    def set_capacity(self, capacity_bytes: int) -> int:
        with self._log.update() as (st, emit):
            emit({"op": "cap", "c": max(int(capacity_bytes), 0)})
            self._evict_until_fits(st, emit, 0)
            self.capacity = st.capacity
        return self.capacity

    def used_bytes(self) -> int:
        with self._log.view() as st:
            return st.used

    def entry_count(self) -> int:
        with self._log.view() as st:
            return len(st.entries)

    def compact(self) -> None:
        """Force a log compaction now (tests / maintenance)."""
        self._log.compact()


class JsonDiskJournal:
    """Legacy rewrite-per-mutation JSON journal (the pre-append-log
    :class:`SharedDiskJournal` implementation), kept behind the identical
    API as the migration source and the benchmark baseline: every mutation
    re-serializes the whole index document under the flock, which is why it
    collapses at large entry counts (``bench_elastic`` measures the gap).
    """

    COORD_SUBDIR = ".coord"

    def __init__(
        self,
        cache_dir: str,
        capacity_bytes: int = 0,
        *,
        reserve_ttl_s: float = 60.0,
    ) -> None:
        self.cache_dir = cache_dir
        self.coord_dir = os.path.join(cache_dir, self.COORD_SUBDIR)
        os.makedirs(self.coord_dir, exist_ok=True)
        self.capacity = max(int(capacity_bytes), 0)
        self.reserve_ttl_s = reserve_ttl_s
        self.index_path = os.path.join(self.coord_dir, "index.json")
        self._flock = FileLock(os.path.join(self.coord_dir, "index.lock"))

    # -- state I/O (only ever called under the flock) ------------------------
    def _load(self) -> Tuple[int, List[_JEntry]]:
        try:
            with open(self.index_path, "r") as f:
                doc = json.load(f)
        except (FileNotFoundError, ValueError):
            return self.capacity, []
        entries = [_JEntry(*e) for e in doc.get("entries", [])]
        return int(doc.get("capacity", self.capacity)), entries

    def _save(self, capacity: int, entries: List[_JEntry]) -> None:
        tmp = f"{self.index_path}.tmp{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "capacity": capacity,
                    "entries": [
                        [e.fname, e.size, e.final, e.deadline] for e in entries
                    ],
                },
                f,
            )
        os.replace(tmp, self.index_path)

    @contextmanager
    def _locked(self) -> Iterator[List[_JEntry]]:
        with self._flock:
            capacity, entries = self._load()
            self.capacity = capacity
            yield entries
            self._save(self.capacity, entries)

    # -- eviction (under lock) -----------------------------------------------
    def _evict_until_fits(
        self, entries: List[_JEntry], need: int
    ) -> Tuple[Optional[List[_JEntry]], int, int]:
        if not self.capacity:
            return [], 0, 0
        now = time.time()
        used = sum(e.size for e in entries)
        victims: List[_JEntry] = []
        while used + need > self.capacity:
            victim = next(
                (e for e in entries if e.final or e.deadline < now), None
            )
            if victim is None:
                return None, 0, 0
            entries.remove(victim)
            used -= victim.size
            victims.append(victim)
        for v in victims:
            try:
                os.remove(os.path.join(self.cache_dir, v.fname))
            except OSError:
                pass
            if not v.final:
                self._reclaim_tmps(v.fname)
        return victims, len(victims), sum(v.size for v in victims)

    _reclaim_tmps = SharedDiskJournal._reclaim_tmps

    # -- operations ----------------------------------------------------------
    def reserve(self, fname: str, size: int) -> ReserveResult:
        with self._locked() as entries:
            now = time.time()
            for e in entries:
                if e.fname == fname:
                    if not e.final and e.deadline < now:
                        entries.remove(e)
                        self._reclaim_tmps(e.fname)
                        break
                    entries.remove(e)
                    entries.append(e)  # MRU
                    return ReserveResult(ok=True, dedup=True)
            if self.capacity and size > self.capacity:
                return ReserveResult(ok=False)
            victims, n, nbytes = self._evict_until_fits(entries, size)
            if victims is None:
                return ReserveResult(ok=False)
            entries.append(
                _JEntry(fname, size, False, time.time() + self.reserve_ttl_s)
            )
            return ReserveResult(ok=True, evicted=n, evicted_bytes=nbytes)

    def finalize(self, fname: str) -> bool:
        with self._locked() as entries:
            for e in entries:
                if e.fname == fname:
                    e.final = True
                    e.deadline = 0.0
                    return True
        return False

    def abort(self, fname: str) -> None:
        with self._locked() as entries:
            for e in entries:
                if e.fname == fname and not e.final:
                    entries.remove(e)
                    return

    def touch(self, fname: str) -> None:
        with self._locked() as entries:
            for e in entries:
                if e.fname == fname and e.final:
                    entries.remove(e)
                    entries.append(e)
                    return

    def set_capacity(self, capacity_bytes: int) -> int:
        with self._locked() as entries:
            self.capacity = max(int(capacity_bytes), 0)
            self._evict_until_fits(entries, 0)
        return self.capacity

    def used_bytes(self) -> int:
        with self._flock:
            _, entries = self._load()
            return sum(e.size for e in entries)

    def entry_count(self) -> int:
        with self._flock:
            _, entries = self._load()
            return len(entries)


# ---------------------------------------------------------------------------
# Cooperative up-probe lease
# ---------------------------------------------------------------------------


@dataclass
class LeaseEvent:
    owner: str
    event: str  # acquire | renew | release | takeover | reap
    t: float
    expires_at: float = 0.0

    def to_json(self) -> str:
        return json.dumps(
            {"owner": self.owner, "event": self.event, "t": self.t,
             "expires_at": self.expires_at}
        )

    @staticmethod
    def from_json(line: str) -> "LeaseEvent":
        d = json.loads(line)
        return LeaseEvent(d["owner"], d["event"], d["t"], d.get("expires_at", 0.0))


class UpProbeLease:
    """TTL lease on the fleet-wide "may probe concurrency upward" token.

    One loader host holds the token at a time; its autotuner may probe
    concurrency/hedging *up* while the others hold their operating point or
    refine downward.  A crashed holder is healed by wall-clock TTL expiry —
    the next ``try_acquire`` after ``expires_at`` takes the token over.
    With a ``membership`` board attached, a holder that VANISHED from the
    fleet (its membership lease expired, or it left) is reaped immediately
    instead of pinning the token for the rest of its TTL — the
    acquire-then-die-before-first-renew window that used to stall every
    peer's up-probes for a full TTL.  All transitions are appended to
    ``events.jsonl`` under the same lock, so a benchmark can audit after
    the fact that no two hosts ever held a live lease concurrently
    (:func:`validate_lease_events`).
    """

    def __init__(
        self,
        coord_dir: str,
        *,
        owner: Optional[str] = None,
        ttl_s: float = 30.0,
        events_max_bytes: int = 4 << 20,
        membership: Optional[Any] = None,
    ) -> None:
        self.dir = coord_dir
        os.makedirs(coord_dir, exist_ok=True)
        self.owner = owner or default_owner()
        self.ttl_s = ttl_s
        # the audit log rotates once (events.jsonl -> events.jsonl.1) past
        # this size, so a multi-day fleet never grows the shared mount
        # unboundedly; benches audit well within one rotation window
        self.events_max_bytes = events_max_bytes
        # MembershipBoard-shaped (is_live(owner) -> bool); None = TTL-only
        self.membership = membership
        self.path = os.path.join(coord_dir, "up_probe.lease")
        self.events_path = os.path.join(coord_dir, "events.jsonl")
        self._lock = FileLock(os.path.join(coord_dir, "up_probe.lock"))

    # -- record I/O (under the flock) ----------------------------------------
    def _read(self) -> Optional[Dict]:
        try:
            with open(self.path, "r") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    def _write(self, expires_at: float) -> None:
        tmp = f"{self.path}.tmp{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump({"owner": self.owner, "expires_at": expires_at}, f)
        os.replace(tmp, self.path)

    def _log(self, event: str, expires_at: float = 0.0) -> None:
        ev = LeaseEvent(self.owner, event, time.time(), expires_at)
        try:
            if (
                self.events_max_bytes
                and os.path.getsize(self.events_path) >= self.events_max_bytes
            ):
                os.replace(self.events_path, self.events_path + ".1")
        except OSError:
            pass
        with open(self.events_path, "a") as f:
            f.write(ev.to_json() + "\n")

    def _holder_vanished(self, rec: Dict) -> bool:
        """True when the recorded holder is gone from the fleet: its
        membership lease expired or it explicitly left.  Only meaningful
        with a membership board; errors read as "still there" (never reap
        on a flaky shared-dir read)."""
        if self.membership is None:
            return False
        try:
            return not self.membership.is_live(rec["owner"])
        except OSError:
            return False

    # -- surface -------------------------------------------------------------
    def try_acquire(self) -> bool:
        with self._lock:
            now = time.time()
            rec = self._read()
            reaped = False
            if rec and rec["owner"] != self.owner and rec["expires_at"] > now:
                if not self._holder_vanished(rec):
                    return False
                # the holder died/left the fleet between acquiring and its
                # next renew: reap its live-looking lease instead of letting
                # the token idle until TTL
                self._log("reap")
                reaped = True
            expires = now + self.ttl_s
            self._write(expires)
            if rec is None:
                event = "acquire"
            elif rec["owner"] == self.owner:
                event = "renew"  # re-entrant refresh by the current holder
            else:
                event = "takeover"  # expired/reaped lease of a dead peer
            self._log(event, expires)
            return True

    def renew(self) -> bool:
        """Extend a held lease; False when it was lost (TTL expired and a
        peer took over) — the caller must stop treating itself as holder."""
        with self._lock:
            rec = self._read()
            if not rec or rec["owner"] != self.owner:
                return False
            expires = time.time() + self.ttl_s
            self._write(expires)
            self._log("renew", expires)
            return True

    def release(self) -> None:
        with self._lock:
            rec = self._read()
            if rec and rec["owner"] == self.owner:
                try:
                    os.remove(self.path)
                except OSError:
                    pass
                self._log("release")

    def read_events(self) -> List[LeaseEvent]:
        try:
            with open(self.events_path, "r") as f:
                return [LeaseEvent.from_json(ln) for ln in f if ln.strip()]
        except FileNotFoundError:
            return []


@dataclass
class LeaseAudit:
    ok: bool
    holders: int  # distinct owners that ever held the lease
    acquisitions: int
    violations: List[str] = field(default_factory=list)


def validate_lease_events(events: List[LeaseEvent]) -> LeaseAudit:
    """Audit an event log: at every acquire/takeover, the previous holder must
    have released, have an expired lease, or have been reaped (vanished from
    the membership board) — i.e. no two live holders ever overlap (the
    bench's "never >1 concurrent up-probe" invariant)."""
    holder: Optional[str] = None
    holder_expires = 0.0
    owners = set()
    acqs = 0
    violations: List[str] = []
    for ev in sorted(events, key=lambda e: e.t):
        if ev.event in ("acquire", "takeover", "renew"):
            if (
                ev.event != "renew"
                and holder is not None
                and holder != ev.owner
                and holder_expires > ev.t
            ):
                violations.append(
                    f"{ev.owner} acquired at {ev.t:.3f} while {holder} held a "
                    f"live lease (expires {holder_expires:.3f})"
                )
            if ev.event == "renew" and holder != ev.owner:
                # a renew only succeeds for the recorded holder
                violations.append(f"{ev.owner} renewed without holding")
            holder = ev.owner
            holder_expires = ev.expires_at
            owners.add(ev.owner)
            if ev.event in ("acquire", "takeover"):
                acqs += 1
        elif ev.event == "release":
            if holder == ev.owner:
                holder = None
                holder_expires = 0.0
        elif ev.event == "reap":
            # the recorded holder vanished from the membership board; the
            # reaper (ev.owner) invalidated the lease under the lock
            holder = None
            holder_expires = 0.0
    return LeaseAudit(not violations, len(owners), acqs, violations)


# ---------------------------------------------------------------------------
# Elastic membership
# ---------------------------------------------------------------------------


def _membership_state() -> Dict[str, Any]:
    return {"gen": 0, "members": {}}


def _membership_apply(st: Dict[str, Any], rec: Dict[str, Any]) -> None:
    op = rec.get("op")
    if op == "join":
        if rec["m"] not in st["members"]:
            st["gen"] += 1
        st["members"][rec["m"]] = [float(rec["e"]), float(rec.get("t", 0.0))]
    elif op == "hb":
        m = st["members"].get(rec["m"])
        if m is not None:
            m[0] = float(rec["e"])
        else:
            # a heartbeat from a member that was reaped re-joins it (a slow
            # host is still a host — but the fleet did observe a change)
            st["gen"] += 1
            st["members"][rec["m"]] = [float(rec["e"]), float(rec["e"])]
    elif op == "leave":
        if st["members"].pop(rec["m"], None) is not None:
            st["gen"] += 1
    elif op == "snap":
        st["gen"] = int(rec.get("g", 0))
        st["members"] = {
            m: [float(e), float(j)] for m, (e, j) in rec.get("m", {}).items()
        }


def _membership_snapshot(st: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [{"op": "snap", "g": st["gen"], "m": st["members"]}]


class MembershipBoard:
    """Lease-based fleet membership: a member is live while its heartbeat
    lease is unexpired; expiry IS departure (a kill -9'd host needs no
    goodbye).  Joins and leaves (explicit or reaped) bump a fleet
    *generation*, so elastic consumers can cheaply detect "the fleet
    changed" and recompute shard ownership (:func:`slot_owners`).

    ``clock`` is injectable so chaos tests can model clock-skewed hosts;
    production always uses wall time, since lease expiry must compare
    across processes.  Join/leave/reap transitions (not heartbeats) are
    mirrored to ``membership_audit.jsonl`` for post-mortem artifacts.
    """

    def __init__(
        self,
        coord_dir: str,
        *,
        member: Optional[str] = None,
        ttl_s: float = 10.0,
        clock: Callable[[], float] = time.time,
        compact_every: int = 256,
    ) -> None:
        self.dir = coord_dir
        self.member = member or default_owner()
        self.ttl_s = ttl_s
        self._clock = clock
        self._log = AppendLog(
            coord_dir,
            "membership",
            make_state=_membership_state,
            apply=_membership_apply,
            snapshot=_membership_snapshot,
            compact_every=compact_every,
        )
        self.audit_path = os.path.join(coord_dir, "membership_audit.jsonl")

    def _audit(self, event: str, member: str) -> None:
        try:
            with open(self.audit_path, "a") as f:
                f.write(
                    json.dumps(
                        {
                            "t": time.time(),
                            "event": event,
                            "member": member,
                            "by": self.member,
                        }
                    )
                    + "\n"
                )
        except OSError:  # pragma: no cover - audit is best-effort
            pass

    # -- surface -------------------------------------------------------------
    def join(self) -> int:
        """Register (or refresh) this member; returns the fleet generation."""
        now = self._clock()
        with self._log.update() as (st, emit):
            emit(
                {"op": "join", "m": self.member, "e": now + self.ttl_s, "t": now}
            )
            gen = st["gen"]
        self._audit("join", self.member)
        return gen

    def heartbeat(self) -> int:
        """Extend this member's lease (re-joining if it was reaped) and reap
        any members whose lease expired; returns the fleet generation."""
        now = self._clock()
        reaped: List[str] = []
        with self._log.update() as (st, emit):
            emit({"op": "hb", "m": self.member, "e": now + self.ttl_s})
            for m, (expires, _) in list(st["members"].items()):
                if m != self.member and expires < now:
                    emit({"op": "leave", "m": m})
                    reaped.append(m)
            gen = st["gen"]
        for m in reaped:
            self._audit("reap", m)
        return gen

    def leave(self) -> None:
        with self._log.update() as (st, emit):
            if self.member in st["members"]:
                emit({"op": "leave", "m": self.member})
        self._audit("leave", self.member)

    def live(self, now: Optional[float] = None) -> Dict[str, float]:
        """Live members -> lease expiry (expired entries filtered even if
        not yet reaped by a heartbeat)."""
        t = self._clock() if now is None else now
        with self._log.view() as st:
            return {
                m: e for m, (e, _) in st["members"].items() if e >= t
            }

    def is_live(self, member: str) -> bool:
        return member in self.live()

    def generation(self) -> int:
        with self._log.view() as st:
            return st["gen"]


# ---------------------------------------------------------------------------
# Cooperative down-shedding (AIMD congestion board)
# ---------------------------------------------------------------------------


def _congestion_state() -> Dict[str, Any]:
    return {"seq": 0, "last_t": 0.0, "events": []}


def _congestion_apply(st: Dict[str, Any], rec: Dict[str, Any]) -> None:
    op = rec.get("op")
    if op == "shed":
        st["seq"] += 1
        st["last_t"] = float(rec.get("t", 0.0))
        st["events"].append(
            {
                "seq": st["seq"],
                "h": rec.get("h", ""),
                "t": float(rec.get("t", 0.0)),
                "tput": float(rec.get("tput", 0.0)),
            }
        )
        del st["events"][:-64]  # the state only needs the recent tail
    elif op == "snap":
        st["seq"] = int(rec.get("seq", 0))
        st["last_t"] = float(rec.get("last_t", 0.0))
        st["events"] = list(rec.get("events", []))


def _congestion_snapshot(st: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [
        {
            "op": "snap",
            "seq": st["seq"],
            "last_t": st["last_t"],
            "events": st["events"],
        }
    ]


class CongestionBoard:
    """Fleet-wide shed-event board (the AIMD "congestion experienced" bit).

    Any host observing collapse posts a shed event; every host's controller
    polls the board between measurement windows and, on a fresh event,
    multiplicatively volunteers concurrency back (recovering additively) —
    the cooperative half of AIMD that per-host hill climbing cannot do
    alone, because each host's own revert only gives back its last probe
    step while the link stays collapsed.  Posting is rate-limited under the
    lock (``min_interval_s``) so N hosts observing the same collapse inject
    one fleet-wide shed, not N stacked halvings."""

    def __init__(
        self,
        coord_dir: str,
        *,
        host: Optional[str] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.dir = coord_dir
        self.host = host or default_owner()
        self._clock = clock
        self._log = AppendLog(
            coord_dir,
            "congestion",
            make_state=_congestion_state,
            apply=_congestion_apply,
            snapshot=_congestion_snapshot,
            compact_every=256,
        )

    def post_shed(
        self, tput: float = 0.0, *, min_interval_s: float = 0.0
    ) -> Optional[int]:
        """Post a shed event; returns its sequence number, or None when a
        recent shed (from any host) already covers this collapse."""
        now = self._clock()
        with self._log.update() as (st, emit):
            if min_interval_s and st["last_t"] + min_interval_s > now:
                return None
            emit({"op": "shed", "h": self.host, "t": now, "tput": float(tput)})
            return st["seq"]

    def poll(self, since_seq: int) -> Tuple[int, List[Dict[str, Any]]]:
        """(latest seq, events newer than ``since_seq``)."""
        with self._log.view() as st:
            return st["seq"], [
                e for e in st["events"] if e["seq"] > since_seq
            ]

    def last_seq(self) -> int:
        with self._log.view() as st:
            return st["seq"]


# ---------------------------------------------------------------------------
# Elastic epoch work claiming
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardClaim:
    """A claimed contiguous run of an epoch's global batch ids."""

    shard: int
    start: int  # first global batch id of the shard
    end: int  # one past the last
    next_b: int  # resume point (a takeover resumes mid-shard)


def _shards_state() -> Dict[str, Any]:
    return {"epoch": -1, "n": 0, "k": 0, "shards": {}}


def _shards_apply(st: Dict[str, Any], rec: Dict[str, Any]) -> None:
    op = rec.get("op")
    if op == "init":
        epoch = int(rec["epoch"])
        if epoch == st["epoch"]:
            return  # first writer wins; later inits are idempotent
        n, k = int(rec["n"]), max(int(rec["k"]), 1)
        st["epoch"] = epoch
        st["n"] = n
        st["k"] = k
        st["shards"] = {}
        for i in range(-(-n // k) if n else 0):
            start = i * k
            st["shards"][str(i)] = {
                "o": None,
                "e": 0.0,
                "b": start,
                "end": min(start + k, n),
                "done": False,
            }
    elif op == "snap":
        st["epoch"] = int(rec.get("epoch", -1))
        st["n"] = int(rec.get("n", 0))
        st["k"] = int(rec.get("k", 0))
        st["shards"] = {str(i): dict(s) for i, s in rec.get("shards", {}).items()}
    else:
        sh = st["shards"].get(str(rec.get("s")))
        if sh is None:
            return
        if op == "claim":
            sh["o"] = rec["o"]
            sh["e"] = float(rec["e"])
        elif op == "renew":
            if sh["o"] == rec["o"]:
                sh["e"] = float(rec["e"])
        elif op == "prog":
            sh["b"] = max(sh["b"], int(rec["b"]))
        elif op == "done":
            sh["done"] = True
            sh["o"] = None
            sh["b"] = sh["end"]
        elif op == "rel":
            if sh["o"] == rec.get("o", sh["o"]):
                sh["o"] = None
                sh["e"] = 0.0


def _shards_snapshot(st: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [
        {
            "op": "snap",
            "epoch": st["epoch"],
            "n": st["n"],
            "k": st["k"],
            "shards": st["shards"],
        }
    ]


class EpochShardBoard:
    """Elastic work queue over an epoch's global batch space.

    The epoch's ``num_batches`` batches are split into contiguous shards of
    ``shard_batches``; hosts claim shards under TTL leases and post a
    done-through progress cursor after each *delivered* batch, so:

    * a host that dies mid-shard is taken over at its last confirmed batch
      (at-least-once for the in-flight tail, never lost);
    * a host that joins mid-epoch simply claims the next unowned shard;
    * the epoch is complete exactly when every shard is done — the union of
      delivered batches over all hosts covers the epoch.

    A claim becomes reapable when its lease expires OR (with a
    ``membership`` board) its owner vanished from the fleet — the same
    liveness rule the up-probe lease uses.  Only the current epoch's state
    is kept: an ``init`` for a newer epoch resets the board, so one log
    serves the whole run."""

    def __init__(
        self,
        coord_dir: str,
        *,
        owner: Optional[str] = None,
        ttl_s: float = 10.0,
        clock: Callable[[], float] = time.time,
        membership: Optional[Any] = None,
        compact_every: int = 512,
    ) -> None:
        self.dir = coord_dir
        self.owner = owner or default_owner()
        self.ttl_s = ttl_s
        self._clock = clock
        self.membership = membership
        self._log = AppendLog(
            coord_dir,
            "shards",
            make_state=_shards_state,
            apply=_shards_apply,
            snapshot=_shards_snapshot,
            compact_every=compact_every,
        )

    def _owner_gone(self, owner: Optional[str]) -> bool:
        if owner is None or self.membership is None:
            return False
        try:
            return not self.membership.is_live(owner)
        except OSError:
            return False

    # -- surface -------------------------------------------------------------
    def setup(self, epoch: int, num_batches: int, shard_batches: int) -> int:
        """Idempotently initialize the epoch's shard table (first writer
        wins); returns the number of shards."""
        with self._log.update() as (st, emit):
            if st["epoch"] != epoch:
                emit(
                    {
                        "op": "init",
                        "epoch": int(epoch),
                        "n": int(num_batches),
                        "k": int(shard_batches),
                    }
                )
            return len(st["shards"])

    def claim_next(
        self, epoch: int, exclude: FrozenSet[int] = frozenset()
    ) -> Optional[ShardClaim]:
        """Claim the next available shard: unowned, lease-expired, or owned
        by a departed member (takeover resumes at its progress cursor).
        None when every remaining shard is done or live-claimed.

        ``exclude`` skips shards the caller already dispatched locally this
        epoch — the board's progress cursor lags delivery confirmation, so
        without it a host would re-claim (and re-run) its own in-flight
        shard the moment it finished dispatching it."""
        now = self._clock()
        with self._log.update() as (st, emit):
            if st["epoch"] != epoch:
                return None
            for i in sorted(st["shards"], key=int):
                sh = st["shards"][i]
                if sh["done"] or sh["b"] >= sh["end"] or int(i) in exclude:
                    continue
                if sh["o"] == self.owner:
                    pass  # re-claiming our own shard (e.g. after a restart)
                elif sh["o"] is not None and sh["e"] >= now:
                    if not self._owner_gone(sh["o"]):
                        continue  # live peer owns it
                emit(
                    {
                        "op": "claim",
                        "s": int(i),
                        "o": self.owner,
                        "e": now + self.ttl_s,
                    }
                )
                return ShardClaim(
                    shard=int(i),
                    start=int(i) * st["k"],
                    end=sh["end"],
                    next_b=sh["b"],
                )
        return None

    def renew(self, epoch: int, shard: int) -> bool:
        """Extend this owner's claim lease; False when the claim was lost."""
        now = self._clock()
        with self._log.update() as (st, emit):
            if st["epoch"] != epoch:
                return False
            sh = st["shards"].get(str(shard))
            if sh is None or sh["o"] != self.owner:
                return False
            emit(
                {"op": "renew", "s": int(shard), "o": self.owner,
                 "e": now + self.ttl_s}
            )
            return True

    def progress(self, epoch: int, shard: int, next_b: int) -> None:
        """Post the done-through cursor: every batch below ``next_b`` has
        been DELIVERED (not merely dispatched) by the claim's owner."""
        with self._log.update() as (st, emit):
            if st["epoch"] != epoch:
                return
            sh = st["shards"].get(str(shard))
            if sh is None:
                return
            emit({"op": "prog", "s": int(shard), "b": int(next_b)})
            if sh["b"] >= sh["end"] and not sh["done"]:
                emit({"op": "done", "s": int(shard)})

    def complete(self, epoch: int, shard: int) -> None:
        with self._log.update() as (st, emit):
            if st["epoch"] != epoch:
                return
            sh = st["shards"].get(str(shard))
            if sh is not None and not sh["done"]:
                emit({"op": "done", "s": int(shard)})

    def release(self, epoch: int, shard: int) -> None:
        """Give an unfinished claim back (clean shutdown mid-shard)."""
        with self._log.update() as (st, emit):
            if st["epoch"] != epoch:
                return
            sh = st["shards"].get(str(shard))
            if sh is not None and sh["o"] == self.owner:
                emit({"op": "rel", "s": int(shard), "o": self.owner})

    def all_done(self, epoch: int) -> bool:
        with self._log.view() as st:
            return st["epoch"] == epoch and all(
                sh["done"] for sh in st["shards"].values()
            )

    def snapshot(self, epoch: int) -> Dict[str, Any]:
        """Debug/bench view of the current shard table."""
        with self._log.view() as st:
            if st["epoch"] != epoch:
                return {}
            return {i: dict(sh) for i, sh in st["shards"].items()}
