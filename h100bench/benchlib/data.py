"""The general traffic generator: the inputs of a run, made from ``--seed``.

A traffic file (``traffic/<name>.json``) gives the store, the loader and,
for each kind of data, its sizes.  The same seed gives the same inputs, and
every seed gives the same amount of work: blob sizes are fixed quantiles
of the size distribution, which the seed only deals out to other blobs.

The image recipe follows ``repro_torch/data/imagenet_synth.py``'s
(lognormal sizes around the mean, the 469:387 aspect, a diagonal gradient
plus noise in [0, 64), here in integer arithmetic); the blob layout is the program's codec (``RIMG``/``RTOK``
headers), written here from its published field order.  Nothing here
imports the program.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np

NUM_CLASSES = 1000
IMAGE_PREFIX = "imagenet/train/"
TOKEN_PREFIX = "tokens/train/"


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """One numpy stream a purpose, any non-negative seed (also past 64 bits)."""
    if seed < 0:
        raise ValueError(f"--seed must be a non-negative integer, got {seed}")
    return np.random.default_rng([stream, seed])


@dataclass
class ImagePool:
    """The distinct images that the keys are dealt from: key i holds
    ``blobs[i % len(blobs)]``.  ``pixels[j]`` views blob j's payload."""

    blobs: List[bytes]
    pixels: List[np.ndarray]  # (H, W, 3) uint8, views of the blobs
    labels: np.ndarray  # (pool,) int64
    keys: int

    def index_of(self, key_index: int) -> int:
        return key_index % len(self.blobs)


def image_sizes(spec: Dict) -> List[tuple]:
    """(H, W) of every pool image: the quantiles (i + 1/2) / pool of the
    lognormal byte size, shaped at the given aspect, in quantile order."""
    n, avg = spec["pool"], spec["avg_kb"] * 1024.0
    aspect = spec["aspect"][0] / spec["aspect"][1]
    normal = NormalDist()
    out = []
    for i in range(n):
        target = np.exp(spec["size_sigma"] * normal.inv_cdf((i + 0.5) / n)) * avg
        h = max(32, int(np.sqrt(target / 3.0 / aspect)))
        out.append((h, max(32, int(h * aspect))))
    return out


def make_image_pool(seed: int, spec: Dict) -> ImagePool:
    rng = seed_rng(seed, 1)
    sizes = image_sizes(spec)
    order = rng.permutation(len(sizes))
    labels = rng.integers(0, NUM_CLASSES, size=len(sizes))
    total = sum(h * w * 3 for h, w in sizes)
    noise = rng.bit_generator.random_raw(-(-total // 8)).view(np.uint8)[:total]
    noise &= 63  # uniform in [0, 64), one draw for the pool
    blobs, pixels, off = [], [], 0
    for j in range(len(sizes)):
        h, w = sizes[order[j]]
        # a gradient of at most 126 across the image, plus the noise: no overflow
        ramp = np.add.outer(np.arange(h, dtype=np.uint16) * 64 // h,
                            np.arange(w, dtype=np.uint16) * 64 // w).astype(np.uint8)
        px = noise[off:off + h * w * 3].reshape(h, w, 3)
        px += ramp[..., None]
        off += h * w * 3
        header = b"RIMG" + struct.pack("<IIIIB", h, w, 3, int(labels[j]), 0)
        blob = header + px.tobytes()
        blobs.append(blob)
        pixels.append(np.frombuffer(blob, np.uint8, offset=len(header)).reshape(h, w, 3))
    return ImagePool(blobs, pixels, labels.astype(np.int64), spec["keys"])


@dataclass
class TokenSet:
    tokens: np.ndarray  # (sequences, seq_len + 1) int32
    blobs: List[bytes]


def make_token_set(seed: int, spec: Dict, vocab_size: int) -> TokenSet:
    rng = seed_rng(seed, 2)
    n, t = spec["sequences"], spec["seq_len"] + 1
    tokens = rng.integers(0, vocab_size, size=(n, t), dtype=np.int32)
    header = b"RTOK" + struct.pack("<I", t)
    return TokenSet(tokens, [header + row.tobytes() for row in tokens])
