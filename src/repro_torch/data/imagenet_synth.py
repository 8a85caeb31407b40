"""Synthetic ImageNet-like dataset.

The paper trains ResNet-18 on ImageNet ILSVRC-2012 (avg item ~115 kB, avg
dims 469x387).  Two equivalent sources, deterministic from the key hash:

* :func:`build_synthetic_imagenet` materializes N encoded images into any
  ObjectStore;
* :class:`SyntheticImageStore` generates the blob for a key on demand, so a
  large "dataset" costs no RAM up front; wrapped in SimulatedS3Store it
  behaves like remote blobs.

Sizes are drawn lognormally around ``avg_kb``.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from repro_torch.data.codec import encode_image
from repro_torch.data.store import InMemoryStore, KeyNotFound, ObjectStore

DEFAULT_PREFIX = "imagenet/train/"
NUM_CLASSES = 1000


def item_key(index: int, prefix: str = DEFAULT_PREFIX) -> str:
    return f"{prefix}{index:08d}.rimg"


def _rng_for(seed: int, key: str) -> np.random.Generator:
    h = hashlib.blake2b(f"{seed}:{key}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


def synth_image_bytes(seed: int, key: str, avg_kb: float = 115.0,
                      size_sigma: float = 0.35) -> bytes:
    """Deterministically synthesize one encoded image blob for ``key``."""
    rng = _rng_for(seed, key)
    target = rng.lognormal(0.0, size_sigma) * avg_kb * 1024.0
    # uncompressed uint8 HWC: pick H,W near the paper's 469x387 aspect so that
    # H*W*3 ~= target bytes.
    aspect = 469.0 / 387.0
    h = max(32, int(np.sqrt(target / 3.0 / aspect)))
    w = max(32, int(h * aspect))
    # cheap-but-nontrivial content: low-freq gradient + noise
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    base = (yy * 127 + xx * 127)[..., None]
    noise = rng.integers(0, 64, size=(h, w, 3), dtype=np.uint8)
    px = np.clip(base + noise, 0, 255).astype(np.uint8)
    label = int(rng.integers(0, NUM_CLASSES))
    return encode_image(px, label, compress=0)


class SyntheticImageStore(ObjectStore):
    """Generates image blobs on GET; deterministic; O(1) memory."""

    def __init__(self, num_items: int, seed: int = 0, avg_kb: float = 115.0,
                 prefix: str = DEFAULT_PREFIX, size_sigma: float = 0.35) -> None:
        self.num_items = num_items
        self.seed = seed
        self.avg_kb = avg_kb
        self.prefix = prefix
        self.size_sigma = size_sigma

    def _check(self, key: str) -> None:
        if not key.startswith(self.prefix):
            raise KeyNotFound(key)
        try:
            idx = int(key[len(self.prefix):].split(".")[0])
        except ValueError:
            raise KeyNotFound(key) from None
        if not (0 <= idx < self.num_items):
            raise KeyNotFound(key)

    def get(self, key: str) -> bytes:
        self._check(key)
        return synth_image_bytes(self.seed, key, self.avg_kb, self.size_sigma)

    def put(self, key: str, data: bytes) -> None:
        raise StoreReadOnly("SyntheticImageStore is read-only")

    def list_keys(self, prefix: str = "") -> List[str]:
        keys = [item_key(i, self.prefix) for i in range(self.num_items)]
        return [k for k in keys if k.startswith(prefix)]


class StoreReadOnly(RuntimeError):
    pass


def build_synthetic_imagenet(
    store: Optional[ObjectStore] = None,
    num_items: int = 1024,
    seed: int = 0,
    avg_kb: float = 115.0,
    prefix: str = DEFAULT_PREFIX,
) -> ObjectStore:
    """Materialize ``num_items`` encoded images into ``store``."""
    if store is None:
        store = InMemoryStore()
    for i in range(num_items):
        key = item_key(i, prefix)
        store.put(key, synth_image_bytes(seed, key, avg_kb))
    return store
