"""Host-side augmentation pipeline (the paper's fixed ``transform``):

1) random resized crop to 224x224, 2) random horizontal flip,
3) convert to float tensor (CHW), 4) normalize.

Pure numpy, stateless given an ``np.random.Generator`` — deterministic per
(item, epoch) seed so loader implementations can be compared bit-exactly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def random_resized_crop(
    img: np.ndarray,
    rng: np.random.Generator,
    out_size: int = 224,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> np.ndarray:
    """(H,W,C) uint8 -> (out,out,C) uint8; torchvision-style RRC with
    nearest-neighbour resize (cheap on CPU; codec cost modelled elsewhere)."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        r = np.exp(log_r)
        cw = int(round(np.sqrt(target_area * r)))
        ch = int(round(np.sqrt(target_area / r)))
        if 0 < cw <= w and 0 < ch <= h:
            y0 = int(rng.integers(0, h - ch + 1))
            x0 = int(rng.integers(0, w - cw + 1))
            crop = img[y0 : y0 + ch, x0 : x0 + cw]
            break
    else:  # fallback: center crop
        side = min(h, w)
        y0, x0 = (h - side) // 2, (w - side) // 2
        crop = img[y0 : y0 + side, x0 : x0 + side]
    ch, cw = crop.shape[:2]
    yi = (np.arange(out_size) * (ch / out_size)).astype(np.int64)
    xi = (np.arange(out_size) * (cw / out_size)).astype(np.int64)
    return crop[yi[:, None], xi[None, :]]


def horizontal_flip(img: np.ndarray, rng: np.random.Generator, p: float = 0.5) -> np.ndarray:
    if rng.random() < p:
        return img[:, ::-1]
    return img


def to_tensor_normalize(img: np.ndarray) -> np.ndarray:
    """(H,W,C) uint8 -> (C,H,W) float32 normalized."""
    x = img.astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def imagenet_transform_raw(img: np.ndarray, rng: np.random.Generator, out_size: int = 224) -> np.ndarray:
    """The RNG-consuming half of the transform only: crop + flip, still uint8
    HWC.  This is where the host stages stop when the cast/normalize/layout
    tail runs on the accelerator (``kernels/ingest_norm``) — 4x fewer bytes
    cross every host boundary (shm slot, staging buffer, PCIe/ICI).  Consumes
    the generator in exactly the same order as :func:`imagenet_transform`, so
    ``to_tensor_normalize(imagenet_transform_raw(img, rng))`` is bit-identical
    to the fused host path."""
    img = random_resized_crop(img, rng, out_size)
    img = horizontal_flip(img, rng)
    return np.ascontiguousarray(img)


def imagenet_transform(img: np.ndarray, rng: np.random.Generator, out_size: int = 224) -> np.ndarray:
    return to_tensor_normalize(imagenet_transform_raw(img, rng, out_size))
