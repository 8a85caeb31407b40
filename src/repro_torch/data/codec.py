"""Item codecs.

The paper stores JPEG images.  We mimic the *size distribution* (~115 kB
average) and a realistic decode cost with a simple self-describing binary
format: a fixed header + (optionally zlib-compressed) uint8 pixel payload.
Token shards for the LM architectures are raw int32 arrays with a header.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

_IMG_MAGIC = b"RIMG"
_TOK_MAGIC = b"RTOK"


@dataclass
class ImageRecord:
    pixels: np.ndarray  # (H, W, C) uint8
    label: int


def encode_image(pixels: np.ndarray, label: int, compress: int = 0) -> bytes:
    assert pixels.dtype == np.uint8 and pixels.ndim == 3
    h, w, c = pixels.shape
    payload = pixels.tobytes()
    if compress:
        payload = zlib.compress(payload, compress)
    header = _IMG_MAGIC + struct.pack("<IIIIB", h, w, c, label, 1 if compress else 0)
    return header + payload


def decode_image(data: bytes) -> ImageRecord:
    if data[:4] != _IMG_MAGIC:
        raise ValueError("not an RIMG record")
    h, w, c, label, compressed = struct.unpack("<IIIIB", data[4:21])
    payload = data[21:]
    if compressed:
        payload = zlib.decompress(payload)
    px = np.frombuffer(payload, dtype=np.uint8).reshape(h, w, c)
    return ImageRecord(px, label)


def encode_tokens(tokens: np.ndarray) -> bytes:
    assert tokens.dtype == np.int32 and tokens.ndim == 1
    return _TOK_MAGIC + struct.pack("<I", tokens.shape[0]) + tokens.tobytes()


def decode_tokens(data: bytes) -> np.ndarray:
    if data[:4] != _TOK_MAGIC:
        raise ValueError("not an RTOK record")
    (n,) = struct.unpack("<I", data[4:8])
    return np.frombuffer(data[8 : 8 + 4 * n], dtype=np.int32)
