"""Shard streaming (WebDataset analogue — paper §A.5).

A *shard* is a tar archive of encoded items stored as one object.  Streaming
a shard costs one large GET (amortizing per-request latency) instead of
per-item GETs — the paper shows this beats the per-item ConcurrentDataloader
on S3.  We implement:

* :func:`write_shards`   — pack a dataset into N-item tar shards.
* :class:`ShardedIterableDataset` — stream shards, unpack on the fly, yield
  decoded items (optionally shuffled within a shard buffer).

The reference's module: the same tar members (names and bytes) and the same
item stream, whose augment rng is keyed by the position in the stream.
Items are host-normalized float32 CHW numpy arrays.  It imports no
``torch``.
"""
from __future__ import annotations

import io
import tarfile
from typing import Iterator, List, Sequence

import numpy as np

from repro_torch.data import codec
from repro_torch.data.augment import imagenet_transform
from repro_torch.data.dataset import Item, _aug_rng
from repro_torch.data.store import ObjectStore


def shard_key(shard_idx: int, prefix: str = "shards/train/") -> str:
    return f"{prefix}{shard_idx:06d}.tar"


def write_shards(
    src: ObjectStore,
    dst: ObjectStore,
    keys: Sequence[str],
    items_per_shard: int = 256,
    prefix: str = "shards/train/",
) -> List[str]:
    """Pack the blobs at ``keys`` (in order) into tar shards in ``dst``."""
    out_keys = []
    for s, start in enumerate(range(0, len(keys), items_per_shard)):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            for k in keys[start : start + items_per_shard]:
                data = src.get(k)
                info = tarfile.TarInfo(name=k.replace("/", "__"))
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
        key = shard_key(s, prefix)
        dst.put(key, buf.getvalue())
        out_keys.append(key)
    return out_keys


class ShardedIterableDataset:
    """Iterates decoded items by streaming tar shards from a store."""

    def __init__(
        self,
        store: ObjectStore,
        shard_keys: Sequence[str],
        out_size: int = 224,
        augment: bool = True,
        seed: int = 0,
        shuffle_buffer: int = 0,
        sim_decode_s_per_mb: float = 0.0,
    ) -> None:
        self.store = store
        self.shard_keys = list(shard_keys)
        self.out_size = out_size
        self.augment = augment
        self.seed = seed
        self.shuffle_buffer = shuffle_buffer
        self.sim_decode_s_per_mb = sim_decode_s_per_mb
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _decode(self, raw: bytes, index: int) -> Item:
        if self.sim_decode_s_per_mb:
            import time

            time.sleep(self.sim_decode_s_per_mb * len(raw) / 1e6)
        rec = codec.decode_image(raw)
        if self.augment:
            rng = _aug_rng(self.seed, self._epoch, index)
            img = imagenet_transform(rec.pixels, rng, self.out_size)
        else:
            img = rec.pixels[: self.out_size, : self.out_size].transpose(2, 0, 1).astype(np.float32)
        return {"image": img, "label": np.int32(rec.label), "nbytes": np.int64(len(raw))}

    def _iter_raw(self) -> Iterator[bytes]:
        # WebDataset semantics: stream shard n while shard n+1 downloads in
        # the background (the torch DataLoader worker does this overlap).
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1, thread_name_prefix="shard-prefetch") as ex:
            nxt = ex.submit(self.store.get, self.shard_keys[0]) if self.shard_keys else None
            for i, sk in enumerate(self.shard_keys):
                blob = nxt.result()
                if i + 1 < len(self.shard_keys):
                    nxt = ex.submit(self.store.get, self.shard_keys[i + 1])
                with tarfile.open(fileobj=io.BytesIO(blob), mode="r") as tar:
                    for member in tar.getmembers():
                        f = tar.extractfile(member)
                        if f is not None:
                            yield f.read()

    def __iter__(self) -> Iterator[Item]:
        rng = np.random.default_rng(self.seed + self._epoch)
        buf: List[bytes] = []
        idx = 0
        for raw in self._iter_raw():
            if self.shuffle_buffer:
                buf.append(raw)
                if len(buf) >= self.shuffle_buffer:
                    j = int(rng.integers(0, len(buf)))
                    buf[j], buf[-1] = buf[-1], buf[j]
                    yield self._decode(buf.pop(), idx)
                    idx += 1
            else:
                yield self._decode(raw, idx)
                idx += 1
        while buf:
            j = int(rng.integers(0, len(buf)))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield self._decode(buf.pop(), idx)
            idx += 1
