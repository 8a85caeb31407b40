"""Wrappers for the fused ingest epilogue.

``ingest_norm`` is the tensor op (u8 NHWC -> normalized NCHW).  On a CUDA
tensor it launches the hand-written kernel in ``csrc/ingest_norm.cu`` (built
with nvcc at first use) or raises; it takes the plain version
(:func:`~repro_torch.kernels.ingest_norm.ref.ingest_norm_ref`) only for a
tensor on the CPU.  ``ingest_norm.launches`` counts kernel launches.

The kernel takes a vector path (16-byte loads and stores) or a scalar one,
chosen by shape in :func:`path_for`, never on a failure: a failed build or
launch raises.

A fake tensor that stands for the card (:mod:`repro_torch.kernels.cost`)
gets a fake output and reports :func:`cost` to the op counter; nothing
launches.

``make_ingest_fn`` packages it as the batch-level epilogue the training loop
hands to :class:`repro_torch.core.prefetch.DevicePrefetchRing`.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.build import Built, load_cuda_library
from repro_torch.kernels.cost import KernelCost, record, stands_for_card
from repro_torch.kernels.ingest_norm.ref import ingest_norm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ingest_norm.cu"
MAX_C = 4
RUN_PIXELS = 2560  # pixels a block (csrc RUN)
MAX_BLOCKS = 2**31 - 1  # gridDim.x
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def path_for(shape: Sequence[int], out_dtype: torch.dtype, data_ptr: int = 0) -> str:
    """``"vector"`` when every block's run of pixels is a whole number of
    16-byte vectors on both sides: its input bytes (H*W*C % 16 == 0 and the
    input 16-byte aligned) and each plane's outputs (H*W a multiple of 4 f32
    or 8 bf16); ``"scalar"`` otherwise."""
    _, H, W, C = shape
    per_vector = 16 // (4 if out_dtype == torch.float32 else 2)
    if (H * W * C) % 16 == 0 and (H * W) % per_vector == 0 and data_ptr % 16 == 0:
        return "vector"
    return "scalar"


def build() -> Built:
    """Compile (once) and load the kernel library; declares the C signature."""
    built = load_cuda_library("ingest_norm", SOURCE)
    fn = built.lib.ingest_norm_u8
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        occ = built.lib.ingest_norm_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        occ.restype = ctypes.c_int
        err = built.lib.ingest_norm_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built


def occupancy(C: int, out_dtype: torch.dtype, path: str) -> dict:
    """Resident blocks an SM of the kernel for C channels, the output type
    and the path, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives
    it, with its threads and pixels a block.  Needs the card."""
    threads, run = ctypes.c_int(0), ctypes.c_int(0)
    n = build().lib.ingest_norm_occupancy(C, _OUT_CODES[out_dtype], int(path == "vector"),
                                          ctypes.byref(threads), ctypes.byref(run))
    if n <= 0:
        raise RuntimeError(f"ingest_norm occupancy of C={C}, {out_dtype}, {path}: error {n}")
    return {"C": C, "out_dtype": str(out_dtype), "path": path, "threads": threads.value,
            "run_pixels": run.value, "blocks_per_sm": n,
            "warps_per_sm": n * -(-threads.value // 32)}


def cost(shape: Sequence[int], out_dtype: torch.dtype = torch.float32) -> KernelCost:
    """A launch on (B,H,W,C) u8: the input read once and the (B,C,H,W)
    output written once; no operation the bound counts."""
    return KernelCost(0.0, math.prod(shape) * (1 + out_dtype.itemsize), "fp32")


def _affine(mean: Any, std: Any, C: int):
    """scale = 1/(255*std), bias = -mean/std, in float32 as the TPU kernel's
    wrapper computes them."""
    m = np.asarray(torch.as_tensor(mean, dtype=torch.float32).cpu(), np.float32).reshape(-1)
    s = np.asarray(torch.as_tensor(std, dtype=torch.float32).cpu(), np.float32).reshape(-1)
    if m.shape != (C,) or s.shape != (C,):
        raise ValueError(f"mean/std must have {C} entries, got {m.shape} and {s.shape}")
    scale = np.float32(1.0) / (np.float32(255.0) * s)
    bias = -m / s
    return scale.astype(np.float32), bias.astype(np.float32)


def ingest_norm(
    img: torch.Tensor, mean: Any, std: Any, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B,H,W,C) uint8 -> (B,C,H,W) ``out_dtype`` as (x/255 - mean)/std."""
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"img must be a torch.Tensor, got {type(img).__name__}")
    if img.dtype != torch.uint8 or img.dim() != 4:
        raise ValueError(f"img must be 4-D uint8 (B,H,W,C), got {img.dtype} {tuple(img.shape)}")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    card = stands_for_card(img)
    if img.device.type == "cpu" and not card:
        return ingest_norm_ref(
            img, torch.as_tensor(mean, dtype=torch.float32),
            torch.as_tensor(std, dtype=torch.float32), out_dtype,
        )
    if img.device.type != "cuda" and not card:
        raise ValueError(f"ingest_norm runs on 'cuda' or 'cpu' tensors, got {img.device}")
    B, H, W, C = img.shape
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    if not (1 <= C <= MAX_C):
        raise ValueError(f"ingest_norm kernel takes 1..{MAX_C} channels, got {C}")
    if B * -(-H * W // RUN_PIXELS) > MAX_BLOCKS:
        raise ValueError(f"{tuple(img.shape)} needs more blocks than the kernel's grid takes")
    out = torch.empty((B, C, H, W), dtype=out_dtype, device=img.device)
    if card:
        return record("ingest_norm", cost(img.shape, out_dtype), out)
    scale, bias = _affine(mean, std, C)
    if img.numel() == 0:
        return out
    vector = int(path_for(img.shape, out_dtype, img.data_ptr()) == "vector")
    lib = build().lib
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.ingest_norm_u8(
            img.data_ptr(), out.data_ptr(), B, H, W, C,
            scale.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            bias.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _OUT_CODES[out_dtype], vector, stream,
        )
    if rc != 0:
        msg = lib.ingest_norm_error_string(rc).decode()
        raise RuntimeError(f"ingest_norm kernel launch failed: {msg} (cudaError {rc})")
    ingest_norm.launches += 1
    return out


ingest_norm.launches = 0


def make_ingest_fn(
    mean: Optional[Any] = None,
    std: Optional[Any] = None,
    *,
    key: str = "image",
    out_dtype: torch.dtype = torch.float32,
) -> Any:
    """Build the on-device ingest epilogue for ``DevicePrefetchRing``.

    ``mean``/``std`` default to the ImageNet constants of the host transform
    (:mod:`repro_torch.data.augment`).  The returned callable is safe on any
    batch dict: it rewrites ``key`` only when it holds a 4-D uint8 tensor, so
    host-epilogue batches and other pipelines pass through unchanged.
    """
    if mean is None or std is None:
        from repro_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD

        mean = IMAGENET_MEAN if mean is None else mean
        std = IMAGENET_STD if std is None else std
    mean = torch.as_tensor(np.asarray(mean, dtype=np.float32))
    std = torch.as_tensor(np.asarray(std, dtype=np.float32))

    def ingest(batch: Dict[str, Any]) -> Dict[str, Any]:
        img = batch.get(key) if hasattr(batch, "get") else None
        if not isinstance(img, torch.Tensor) or img.dtype != torch.uint8 or img.dim() != 4:
            return dict(batch) if isinstance(batch, dict) else batch
        new = dict(batch)
        new[key] = ingest_norm(img, mean, std, out_dtype)
        return new

    return ingest
