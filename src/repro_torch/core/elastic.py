"""Elastic fleet membership + claim-based epoch scheduling.

Static sharding (``host_id``/``num_hosts``) assumes the fleet is fixed for
the whole run: a crashed host's batches are simply gone, and a new host
cannot help until the next restart.  This module replaces the *assignment*
of batches to hosts — not their content — with claim-based scheduling over
the coord substrate (Uber's elastic-pipeline design in PAPERS.md):

* :class:`ElasticSession` joins a lease-based
  :class:`~repro_torch.core.coord.MembershipBoard` (heartbeat leases; expiry IS
  departure) and owns the epoch's
  :class:`~repro_torch.core.coord.EpochShardBoard`;
* :class:`ElasticBatchSampler` keeps the deterministic
  :class:`~repro_torch.core.sampler.ShardedBatchSampler` permutation but draws
  WHICH batches to load from shard claims, so hosts joining, leaving or
  dying mid-epoch redistribute work without touching batch *content* — the
  union of batches delivered across the fleet is exactly the epoch's batch
  set (bit-identical to a single static host's stream, order aside).

Delivery is at-least-once with *re-entry confirmation*: a batch's progress
is posted only once the consumer has provably moved past it (it came back
to the loader for the next batch), so a SIGKILL between fetch and
consumption re-runs the unconfirmed tail on a surviving host instead of
losing it.  Duplicates are possible across a crash; exactly-once consumers
dedup by the global ids in ``delivered_log``.

The loader's dispatch loop pulls the sampler synchronously, so the sampler
must never block delivery: when every remaining shard is live-claimed by a
peer it raises :class:`ClaimStarved` (after one bounded poll sleep) and the
loader retries on its next dispatch — delivery, and therefore confirmation,
keeps flowing while the fleet converges.  A blocking wait here deadlocks
two hosts each holding the other's termination hostage on an unconfirmed
final batch.

The port's copy has no ``set_filter``: predicate pushdown comes with the
columnar datasets (ROADMAP §1 item 5.5).  Claims, progress and membership
go through :mod:`repro_torch.core.coord` in the reference's on-disk
format, so reference and port members can share one fleet.  The module
imports no ``torch``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config import ElasticConfig
from repro_torch.core.coord import (
    EpochShardBoard,
    MembershipBoard,
    ShardClaim,
    default_owner,
)
from repro_torch.core.sampler import (
    BatchIndices,
    ShardedBatchSampler,
    epoch_permutation,
)


class ClaimStarved(Exception):
    """No shard is claimable *right now* (all live-claimed by peers) but the
    epoch is not done — the caller should keep delivering and retry.  Raised
    instead of blocking; see the module docstring for why blocking deadlocks.
    """


class ElasticSession:
    """One host's standing in the elastic fleet: a membership lease kept
    fresh by rate-limited heartbeats, plus the shared epoch shard board.

    The session outlives individual epochs/iterators; ``leave()`` on clean
    shutdown hands shard claims and the membership slot back immediately
    instead of making survivors wait out the TTL."""

    def __init__(
        self,
        cfg: ElasticConfig,
        *,
        member: Optional[str] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if not cfg.coord_dir:
            raise ValueError("elastic mode requires ElasticConfig.coord_dir")
        self.cfg = cfg
        self.member = member or default_owner()
        self._clock = clock
        self.membership = MembershipBoard(
            cfg.coord_dir, member=self.member, ttl_s=cfg.lease_ttl_s,
            clock=clock,
        )
        self.shards = EpochShardBoard(
            cfg.coord_dir, owner=self.member, ttl_s=cfg.lease_ttl_s,
            clock=clock, membership=self.membership,
        )
        self._last_hb = 0.0
        self._joined = False

    def join(self) -> int:
        gen = self.membership.join()
        self._joined = True
        self._last_hb = self._clock()
        return gen

    def maybe_heartbeat(self) -> None:
        """Refresh our membership lease if it is getting stale; cheap to
        call on every dispatch (rate-limited to heartbeat_interval_s)."""
        now = self._clock()
        if self._joined and now - self._last_hb < self.cfg.heartbeat_interval_s:
            return
        try:
            self.membership.heartbeat() if self._joined else self.join()
        except OSError:
            return  # transient shared-dir error; retry next dispatch
        self._joined = True
        self._last_hb = now

    def leave(self) -> None:
        if self._joined:
            self._joined = False
            try:
                self.membership.leave()
            except OSError:
                pass


class ElasticBatchSampler:
    """Claim-scheduled sampler: deterministic batch *content*, elastic
    batch *assignment*.

    Mirrors the :class:`ShardedBatchSampler` surface the loader wires
    (``set_epoch`` / ``__len__`` / ``state_dict`` /
    iteration yielding :class:`BatchIndices`) but draws batches from
    :class:`EpochShardBoard` claims.  Three contracts the loader relies on:

    * yielded ``batch_id`` is a LOCAL contiguous sequence (0, 1, 2, ...) —
      the loader's in-order delivery requires contiguity — while the true
      global batch ids travel on the confirmation queue and surface in
      ``delivered_log`` for audit/dedup;
    * ``__next__`` never blocks delivery: it raises :class:`ClaimStarved`
      (retryable) when peers hold every remaining shard, and StopIteration
      only when the whole epoch's shard table is done;
    * the loader reports consumption via :meth:`note_delivered`; progress
      reaches the board once the consumer provably consumed a batch (it
      re-entered the loader), which is what makes a mid-crash tail
      recoverable by a survivor.
    """

    def __init__(
        self,
        dataset_len: int,
        global_batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        session: ElasticSession,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        # host_id=0/num_hosts=1: an elastic host loads WHOLE global batches
        # (the claim is the unit of distribution, not a within-batch slice)
        self._inner = ShardedBatchSampler(
            dataset_len, global_batch_size, shuffle=shuffle, seed=seed,
            drop_last=drop_last, host_id=0, num_hosts=1,
        )
        self.session = session
        self._sleep = sleep
        # epoch-iteration state (reset by __iter__)
        self._perm: Optional[np.ndarray] = None
        self._iter_epoch = 0
        self._claim: Optional[ShardClaim] = None
        self._claim_next_b = 0
        # shards fully dispatched by THIS iterator (confirmation may lag the
        # board); excluded from claim_next so we never re-run our own
        # in-flight work.  Reset by __iter__ — a restarted host legitimately
        # re-claims its old shard at the board's progress cursor.
        self._dispatched_shards: set = set()
        self._local_seq = 0
        self._active = False
        # confirmation pipeline: (epoch, shard, global_b) per yielded batch;
        # confirmed in yield order as consumption is proven
        self._pending: List[Tuple[int, int, int]] = []
        self._delivered = 0
        self._confirmed = 0
        self.delivered_log: List[Tuple[int, int]] = []  # (epoch, global_b)

    # -- ShardedBatchSampler surface -----------------------------------------
    @property
    def epoch(self) -> int:
        return self._inner.epoch

    @property
    def next_batch(self) -> int:
        return self._inner.next_batch

    def set_epoch(self, epoch: int) -> None:
        self._inner.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self._inner)

    def state_dict(self) -> Dict[str, int]:
        # claims are not positional, so next_batch is meaningless across a
        # restart — a resumed elastic host just claims whatever is left
        return {"epoch": self._inner.epoch, "next_batch": 0,
                "seed": self._inner.seed, "num_hosts": 1}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._inner.epoch = int(state["epoch"])
        self._inner.next_batch = 0

    # -- delivery confirmation ----------------------------------------------
    def _confirm_through(self, upto: int) -> None:
        """Post progress for the first ``upto`` yielded batches (count)."""
        board = self.session.shards
        while self._confirmed < upto and self._pending:
            epoch, shard, gb = self._pending.pop(0)
            self.delivered_log.append((epoch, gb))
            try:
                board.progress(epoch, shard, gb + 1)
            except OSError:
                pass  # the cursor lags; the claim lease still covers us
            self._confirmed += 1

    def note_delivered(self) -> None:
        """The loader delivered one batch to the consumer.  Confirmation
        lags one batch at this point: delivering batch k only proves the
        consumer took k-1 (it came back for more); k itself is confirmed
        on the next loader re-entry (see ``__next__``) — a host killed
        holding k re-runs it on a survivor rather than losing it."""
        self._delivered += 1
        self._confirm_through(self._delivered - 1)

    def flush_delivered(self) -> None:
        """Epoch finished draining on this host: the consumer has every
        delivered batch, confirm them all."""
        self._confirm_through(self._delivered)

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> "ElasticBatchSampler":
        ses = self.session
        epoch = self._inner.epoch
        ses.maybe_heartbeat()
        inner = self._inner
        self._perm = epoch_permutation(
            inner.dataset_len, inner.seed, epoch, inner.shuffle
        )
        gbs = self._inner.global_batch_size
        if self._inner.drop_last:
            nb = len(self._perm) // gbs
        else:
            nb = -(-len(self._perm) // gbs)
        ses.shards.setup(epoch, nb, ses.cfg.shard_batches)
        self._iter_epoch = epoch
        self._claim = None
        self._claim_next_b = 0
        self._dispatched_shards = set()
        self._local_seq = 0
        self._pending.clear()
        self._delivered = 0
        self._confirmed = 0
        self._active = True
        return self

    def __next__(self) -> BatchIndices:
        if not self._active:
            raise StopIteration
        ses = self.session
        board = ses.shards
        epoch = self._iter_epoch
        gbs = self._inner.global_batch_size
        # the loader pulls the sampler from inside the consumer's own
        # __next__ call, so every batch delivered so far has provably been
        # consumed — confirm them all (this is also what terminates the
        # epoch: the final batch's confirmation flips its shard done)
        self._confirm_through(self._delivered)
        ses.maybe_heartbeat()
        while True:
            if self._claim is not None:
                c = self._claim
                if self._claim_next_b < c.end:
                    gb = self._claim_next_b
                    lo = gb * gbs
                    gbatch = self._perm[lo : lo + gbs]
                    if len(gbatch) == gbs or not self._inner.drop_last:
                        self._claim_next_b += 1
                        if self._claim_next_b < c.end:
                            try:
                                board.renew(epoch, c.shard)
                            except OSError:
                                pass
                        else:
                            self._claim = None  # fully dispatched
                            self._dispatched_shards.add(c.shard)
                        self._pending.append((epoch, c.shard, gb))
                        seq = self._local_seq
                        self._local_seq += 1
                        return BatchIndices(
                            seq, tuple(map(int, gbatch)), len(gbatch)
                        )
                self._claim = None
                self._dispatched_shards.add(c.shard)
                continue
            try:
                claim = board.claim_next(
                    epoch, exclude=frozenset(self._dispatched_shards)
                )
            except OSError:
                claim = None
            if claim is not None:
                self._claim = claim
                self._claim_next_b = claim.next_b
                continue
            # nothing claimable: done, or peers hold everything that's left
            try:
                if board.all_done(epoch):
                    self._active = False
                    # mirror ShardedBatchSampler's epoch advance
                    self._inner.epoch += 1
                    self._inner.next_batch = 0
                    raise StopIteration
            except OSError:
                pass
            self._sleep(ses.cfg.claim_poll_s)
            raise ClaimStarved


__all__ = ["ClaimStarved", "ElasticSession", "ElasticBatchSampler"]
