"""Object-store abstraction: the paper's storage axis (scratch vs S3).

``ObjectStore`` is the minimal S3-like interface (GET/PUT/LIST).  Backends:

* :class:`InMemoryStore`    — dict-backed "scratch" (fast local path).
* :class:`SimulatedS3Store` — wraps any store with a calibrated network
  model: per-GET lognormal latency, per-connection bandwidth, an aggregate
  NIC cap and a bounded connection pool.

Both sync ``get`` and async ``aget`` are provided; the simulated network
sleeps with ``time.sleep`` (releases the GIL — I/O-like) or ``asyncio.sleep``.
The cache tiers of the reference come in a later slice of the port.
"""
from __future__ import annotations

import asyncio
import hashlib
import random
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.config import StoreConfig


class StoreError(RuntimeError):
    pass


class KeyNotFound(StoreError):
    pass


class TransientStoreError(StoreError):
    """Retryable failure (injected by the failure model)."""


class ObjectStore(ABC):
    """S3-like blob interface."""

    @abstractmethod
    def get(self, key: str) -> bytes: ...

    @abstractmethod
    def put(self, key: str, data: bytes) -> None: ...

    @abstractmethod
    def list_keys(self, prefix: str = "") -> List[str]: ...

    def size(self, key: str) -> int:
        return len(self.get(key))

    async def aget(self, key: str) -> bytes:
        """Async GET; default delegates to a thread so sync stores still work."""
        return await asyncio.get_running_loop().run_in_executor(None, self.get, key)

    def close(self) -> None:
        pass


class InMemoryStore(ObjectStore):
    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._data[key]
            except KeyError:
                raise KeyNotFound(key) from None

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(data)

    def list_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def size(self, key: str) -> int:
        with self._lock:
            try:
                return len(self._data[key])
            except KeyError:
                raise KeyNotFound(key) from None


@dataclass
class StoreStats:
    gets: int = 0
    bytes_read: int = 0
    failures: int = 0
    total_wait_s: float = 0.0

    def snapshot(self) -> "StoreStats":
        return StoreStats(self.gets, self.bytes_read, self.failures, self.total_wait_s)


class SimulatedS3Store(ObjectStore):
    """Network model around a backing store.

    GET time = connection-pool wait + lognormal latency + size / bandwidth,
    where bandwidth = min(per-connection bw, NIC bw / concurrent transfers).
    Deterministic per (seed, key, attempt) so experiments are reproducible.
    ``overload_penalty`` scales service time by
    ``oversubscription ** overload_penalty`` once the NIC is oversubscribed.
    """

    def __init__(
        self,
        base: ObjectStore,
        latency_mean_s: float = 0.08,
        latency_sigma: float = 0.5,
        bandwidth_per_conn: float = 25e6,
        nic_bandwidth: float = 1.2e9,
        max_connections: int = 256,
        failure_rate: float = 0.0,
        seed: int = 0,
        time_scale: float = 1.0,
        overload_penalty: float = 0.0,
    ) -> None:
        self.base = base
        self.latency_mean_s = latency_mean_s
        self.latency_sigma = latency_sigma
        self.bandwidth_per_conn = bandwidth_per_conn
        self.nic_bandwidth = nic_bandwidth
        self.max_connections = max_connections
        self.failure_rate = failure_rate
        self.seed = seed
        self.time_scale = time_scale
        self.overload_penalty = overload_penalty
        self._sem = threading.BoundedSemaphore(max_connections)
        self._async_sems: Dict[int, asyncio.Semaphore] = {}
        self._active = 0
        self._active_lock = threading.Lock()
        self._stats = StoreStats()
        self._stats_lock = threading.Lock()
        self._attempt: Dict[str, int] = {}
        self._attempt_lock = threading.Lock()

    # -- deterministic stochastic model -------------------------------------
    def _next_attempt(self, key: str) -> int:
        with self._attempt_lock:
            n = self._attempt.get(key, 0)
            self._attempt[key] = n + 1
            return n

    def _rng(self, key: str, attempt: int) -> random.Random:
        h = hashlib.blake2b(
            f"{self.seed}:{key}:{attempt}".encode(), digest_size=8
        ).digest()
        return random.Random(int.from_bytes(h, "little"))

    def _sample(self, key: str, size: int) -> tuple[float, bool]:
        """Return (service time seconds, fail?) for one GET."""
        attempt = self._next_attempt(key)
        rng = self._rng(key, attempt)
        fail = rng.random() < self.failure_rate
        lat = rng.lognormvariate(0.0, self.latency_sigma) * self.latency_mean_s
        with self._active_lock:
            active = max(self._active, 1)
        bw = min(self.bandwidth_per_conn, self.nic_bandwidth / active)
        dt = lat + size / bw
        if self.overload_penalty:
            saturation = max(self.nic_bandwidth / self.bandwidth_per_conn, 1.0)
            if active > saturation:
                dt *= (active / saturation) ** self.overload_penalty
        return dt * self.time_scale, fail

    def _enter(self) -> None:
        with self._active_lock:
            self._active += 1

    def _exit(self) -> None:
        with self._active_lock:
            self._active -= 1

    def _bump(self, size: int, wait: float, failed: bool) -> None:
        with self._stats_lock:
            self._stats.gets += 1
            self._stats.total_wait_s += wait
            if failed:
                self._stats.failures += 1
            else:
                self._stats.bytes_read += size

    # -- sync path -----------------------------------------------------------
    def get(self, key: str) -> bytes:
        with self._sem:  # connection pool
            self._enter()
            try:
                data = self.base.get(key)
                dt, fail = self._sample(key, len(data))
                time.sleep(dt)
                self._bump(len(data), dt, fail)
                if fail:
                    raise TransientStoreError(f"simulated GET failure for {key}")
                return data
            finally:
                self._exit()

    # -- async path ----------------------------------------------------------
    def _loop_sem(self) -> asyncio.Semaphore:
        key = id(asyncio.get_running_loop())
        if key not in self._async_sems:
            self._async_sems[key] = asyncio.Semaphore(self.max_connections)
        return self._async_sems[key]

    async def aget(self, key: str) -> bytes:
        async with self._loop_sem():
            self._enter()
            try:
                data = self.base.get(key)  # backing read is in-memory/fast
                dt, fail = self._sample(key, len(data))
                await asyncio.sleep(dt)
                self._bump(len(data), dt, fail)
                if fail:
                    raise TransientStoreError(f"simulated GET failure for {key}")
                return data
            finally:
                self._exit()

    def put(self, key: str, data: bytes) -> None:
        self.base.put(key, data)

    def list_keys(self, prefix: str = "") -> List[str]:
        return self.base.list_keys(prefix)

    def size(self, key: str) -> int:
        return self.base.size(key)

    @property
    def stats(self) -> StoreStats:
        with self._stats_lock:
            return self._stats.snapshot()


def build_store(cfg: StoreConfig, base: Optional[ObjectStore] = None,
                time_scale: float = 1.0, seed: int = 0) -> ObjectStore:
    """Assemble the store stack described by a StoreConfig (memory | s3sim)."""
    if cfg.kind not in ("memory", "s3sim"):
        raise ValueError(f"unsupported store kind {cfg.kind!r}; known: 'memory', 's3sim'")
    store: ObjectStore = base if base is not None else InMemoryStore()
    if cfg.kind == "s3sim":
        store = SimulatedS3Store(
            store,
            latency_mean_s=cfg.latency_mean_s,
            latency_sigma=cfg.latency_sigma,
            bandwidth_per_conn=cfg.bandwidth_per_conn,
            nic_bandwidth=cfg.nic_bandwidth,
            max_connections=cfg.max_connections,
            failure_rate=cfg.failure_rate,
            seed=seed,
            time_scale=time_scale,
            overload_penalty=cfg.overload_penalty,
        )
    return store
