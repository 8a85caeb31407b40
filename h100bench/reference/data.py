"""What each step should receive, worked out again from the seed's data.

The loader's contract, written plainly: an epoch's order is a permutation
drawn from blake2b("sampler:{seed}:{epoch}"); batch b holds its items
[b*B, (b+1)*B); an image item takes a random resized crop (torchvision's
scale and ratio ranges, nearest-neighbour resize) and a flip with
p = 1/2, both from a generator seeded by blake2b("aug:{seed}:{epoch}:{i}");
the device normalizes (x/255 - mean)/std into NCHW.  A token item is the
first ``seq_len`` tokens of its sequence and the same shifted by one.
Plain numpy and torch; nothing of the program.
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch

MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _blake_rng(text: str) -> np.random.Generator:
    h = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


def batch_items(n_items: int, batch: int, seed: int, step: int, epoch: int = 0) -> np.ndarray:
    """Item indices of the ``step``-th batch of an epoch (no epoch ends
    inside a checked run)."""
    perm = _blake_rng(f"sampler:{seed}:{epoch}").permutation(n_items)
    return perm[step * batch:(step + 1) * batch]


def crop_flip(img: np.ndarray, seed: int, index: int, out: int, epoch: int = 0) -> np.ndarray:
    """(H, W, 3) uint8 -> (out, out, 3) uint8."""
    rng = _blake_rng(f"aug:{seed}:{epoch}:{index}")
    h, w = img.shape[:2]
    for _ in range(10):
        area = rng.uniform(0.08, 1.0) * h * w
        r = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw, ch = int(round(np.sqrt(area * r))), int(round(np.sqrt(area / r)))
        if 0 < cw <= w and 0 < ch <= h:
            y0 = int(rng.integers(0, h - ch + 1))
            x0 = int(rng.integers(0, w - cw + 1))
            break
    else:
        ch = cw = min(h, w)
        y0, x0 = (h - ch) // 2, (w - cw) // 2
    rows = y0 + (np.arange(out) * (ch / out)).astype(np.int64)
    cols = x0 + (np.arange(out) * (cw / out)).astype(np.int64)
    px = img[rows[:, None], cols[None, :]]
    if rng.random() < 0.5:
        px = px[:, ::-1]
    return px


def image_batch(pixels: Sequence[np.ndarray], labels: np.ndarray, n_keys: int, batch: int,
                seed: int, step: int, out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(B, out, out, 3) uint8 and (B,) labels of a step."""
    items = batch_items(n_keys, batch, seed, step)
    pool = len(pixels)
    imgs = np.stack([crop_flip(pixels[i % pool], seed, int(i), out) for i in items])
    return imgs, labels[items % pool]


def normalize(u8: np.ndarray, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W), (x/255 - mean)/std, in ``dtype``."""
    x = torch.from_numpy(u8).to(dtype) / 255.0
    x = (x - torch.from_numpy(MEAN).to(dtype)) / torch.from_numpy(STD).to(dtype)
    return x.permute(0, 3, 1, 2).contiguous()


def token_batch(tokens: np.ndarray, batch: int, seed: int, step: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    items = batch_items(tokens.shape[0], batch, seed, step)
    rows = tokens[items]
    return rows[:, :-1], rows[:, 1:]
