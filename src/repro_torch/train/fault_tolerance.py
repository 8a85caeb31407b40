"""Fault-tolerance runtime pieces, as the reference's
(``repro/train/fault_tolerance.py``).

* :class:`HeartbeatMonitor`: tracks the liveness of participants; a host
  whose heartbeat is older than ``timeout_s`` is declared dead.  Driven in
  process (each host would post to a coordinator on a cluster).
* :func:`elastic_plan`: a pure function (global batch, alive hosts) ->
  shard map over :func:`repro_torch.core.sampler.shard_plan`; on a
  membership change every survivor recomputes its slice with no
  coordination and no data loss.  A batch the membership does not divide
  raises ``ValueError`` (``shard_plan``'s check; the reference asserts).
* :class:`RestartPolicy`: the crash/restore loop's bounded retries with
  exponential backoff.

Straggler mitigation at the data layer (hedged GETs) lives in
:mod:`repro_torch.core.fetcher`; at the step layer stragglers are absorbed
by the bounded prefetch queue.  The module imports no torch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.sampler import shard_plan


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[int], timeout_s: float = 30.0) -> None:
        self.timeout_s = timeout_s
        self._last: Dict[int, float] = {h: time.monotonic() for h in hosts}

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self._last[host] = time.monotonic() if now is None else now

    def alive(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t <= self.timeout_s)

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items() if now - t > self.timeout_s)


def elastic_plan(global_batch: Sequence[int], alive_hosts: Sequence[int]) -> Dict[int, List[int]]:
    """Re-partition a global batch over the currently alive hosts.

    The rank of host h is its index in the sorted alive list: the plan is a
    pure function of (batch, membership), so every survivor computes the
    same answer independently."""
    alive = sorted(alive_hosts)
    n = len(alive)
    return {h: shard_plan(global_batch, r, n) for r, h in enumerate(alive)}


@dataclass
class RestartPolicy:
    """Resume-from-latest with bounded retries (the driver's crash loop)."""

    max_restarts: int = 3
    backoff_s: float = 1.0
    restarts: int = 0

    def should_restart(self) -> bool:
        return self.restarts < self.max_restarts

    def on_failure(self) -> float:
        """Returns the backoff to sleep; raises once the budget is spent."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(f"exceeded {self.max_restarts} restarts")
        return self.backoff_s * (2 ** (self.restarts - 1))
