"""Deterministic, shardable, resumable batch samplers.

``shard_plan`` is a pure function of (num_hosts, host_id), and the epoch
permutation a pure function of (seed, epoch), so a restart from
(epoch, batch) reproduces the exact item order.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class BatchIndices:
    batch_id: int  # global batch counter within the epoch
    indices: tuple  # the item indices THIS HOST loads (its slice of the batch)
    global_size: int  # full global batch size (for throughput accounting)


def _epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    h = hashlib.blake2b(f"sampler:{seed}:{epoch}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


def epoch_permutation(dataset_len: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    if shuffle:
        return _epoch_rng(seed, epoch).permutation(dataset_len)
    return np.arange(dataset_len)


def shard_plan(global_batch: Sequence[int], host_id: int, num_hosts: int) -> List[int]:
    """Deterministic within-batch shard: host h takes the h-th contiguous
    slice, matching the device layout of a batch-dim-sharded global array."""
    n = len(global_batch)
    per = n // num_hosts
    if per * num_hosts != n:
        raise ValueError("global batch must divide num_hosts")
    return list(global_batch[host_id * per : (host_id + 1) * per])


class ShardedBatchSampler:
    """Yields this host's slice of every global batch, in order.

    Resumable: ``state_dict()``/``load_state_dict()`` capture (epoch,
    next_batch); restarting reproduces the identical stream.
    """

    def __init__(
        self,
        dataset_len: int,
        global_batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        host_id: int = 0,
        num_hosts: int = 1,
    ) -> None:
        if global_batch_size % num_hosts:
            raise ValueError("global_batch_size must divide num_hosts")
        self.dataset_len = dataset_len
        self.global_batch_size = global_batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.epoch = 0
        self.next_batch = 0
        self._filter_fn: Optional[Callable[[int], Optional[np.ndarray]]] = None

    # -- predicate pushdown ----------------------------------------------------
    def set_filter(self, filter_fn: Optional[Callable[[int], Optional[np.ndarray]]]) -> None:
        """Install a per-epoch row filter (columnar predicate pushdown).

        ``filter_fn(epoch)`` returns a boolean keep-mask over dataset indices
        (or None for an unfiltered epoch).  The mask is applied to the epoch
        permutation *preserving permutation order*, so the filtered stream
        equals the unfiltered stream with rejected rows removed; and because
        the mask is a pure function of the epoch, (epoch, next_batch) resume
        cursors replay the identical filtered stream.
        """
        self._filter_fn = filter_fn

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        perm = epoch_permutation(self.dataset_len, self.seed, epoch, self.shuffle)
        if self._filter_fn is not None:
            mask = self._filter_fn(epoch)
            if mask is not None:
                mask = np.asarray(mask, dtype=bool)
                if mask.shape != (self.dataset_len,):
                    raise ValueError(
                        f"filter mask shape {mask.shape} != ({self.dataset_len},)")
                perm = perm[mask[perm]]
        return perm

    def __len__(self) -> int:
        if self.drop_last:
            return self.dataset_len // self.global_batch_size
        return -(-self.dataset_len // self.global_batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.next_batch = 0

    # -- resumability --------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {
            "epoch": self.epoch,
            "next_batch": self.next_batch,
            "seed": self.seed,
            "num_hosts": self.num_hosts,
        }

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.next_batch = int(state["next_batch"])

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> Iterator[BatchIndices]:
        perm = self._epoch_perm(self.epoch)
        if self.drop_last:
            nb = len(perm) // self.global_batch_size
        else:
            nb = -(-len(perm) // self.global_batch_size)
        for b in range(self.next_batch, nb):
            lo = b * self.global_batch_size
            gbatch = perm[lo : lo + self.global_batch_size]
            if len(gbatch) < self.global_batch_size and self.drop_last:
                break
            mine = shard_plan(list(map(int, gbatch)), self.host_id, self.num_hosts)
            self.next_batch = b + 1
            yield BatchIndices(b, tuple(mine), len(gbatch))
        # epoch exhausted; advance for the next __iter__
        self.epoch += 1
        self.next_batch = 0
