"""Wrapper of the RMSNorm kernel.

``rmsnorm(x, scale, eps=1e-6)`` normalizes x (..., d) over its last
dimension with a (d,) scale and returns x's shape and dtype, as the
reference's wrapper (``repro/kernels/rmsnorm/ops.py``) does; x and scale
are each float32 or bfloat16, and may differ.  On CUDA tensors it launches
the hand-written kernel in ``csrc/rmsnorm.cu`` (built with nvcc at first
use) or raises; it takes the plain version
(:func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`) only for tensors on
the CPU.  ``rmsnorm.launches`` counts kernel launches.  The reference pads
the rows to its block; the kernel masks them.

A fake tensor that stands for the card (:mod:`repro_torch.kernels.cost`)
gets a fake output and reports :func:`cost` to the op counter; nothing
launches.

No model calls it, as in the reference: ``apply_norm`` computes the same
function in plain PyTorch.  Like the reference's Pallas kernel (no VJP), it
is forward-only: with grad enabled, an input that requires grad is refused
on both devices.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import Built, load_cuda_library
from repro_torch.kernels.cost import KernelCost, record, stands_for_card
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
ROWS_PER_BLOCK = 8
MAX_ROWS = (2 ** 31 - 1) * ROWS_PER_BLOCK  # gridDim.x * rows a block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> Built:
    """Compile (once) and load the kernel library; declares the C signature."""
    built = load_cuda_library("rmsnorm", SOURCE)
    fn = built.lib.rmsnorm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = built.lib.rmsnorm_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built


def cost(shape, x_dtype: torch.dtype, scale_dtype: torch.dtype) -> KernelCost:
    """A launch on x (..., d): x read and y written once, the scale read
    once; no operation the bound counts."""
    d = shape[-1]
    return KernelCost(0.0, math.prod(shape) * x_dtype.itemsize * 2 + d * scale_dtype.itemsize,
                      "fp32")


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    for name, t in (("x", x), ("scale", scale)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if x.device != scale.device:
        raise ValueError(f"x on {x.device}, scale on {scale.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError(
            "rmsnorm is forward-only (the reference's kernel has no VJP); run it under "
            "torch.no_grad() or use apply_norm")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"x must be non-empty with a last dimension, got {tuple(x.shape)}")
    if scale.shape != (x.shape[-1],):
        raise ValueError(f"scale must be ({x.shape[-1]},), got {tuple(scale.shape)}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) -> x * rsqrt(mean(x^2) + eps) * scale in x.dtype."""
    _check(x, scale)
    if stands_for_card(x):
        return record("rmsnorm", cost(x.shape, x.dtype, scale.dtype), torch.empty_like(x))
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on 'cuda' or 'cpu' tensors, got {x.device}")
    lib = build().lib
    d = x.shape[-1]
    n = x.numel() // d
    if n > MAX_ROWS:
        raise ValueError(f"{n} rows exceed the kernel's grid ({MAX_ROWS})")
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rmsnorm_fwd(x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps,
                             _DTYPES[x.dtype], _DTYPES[scale.dtype], stream)
    if rc != 0:
        msg = lib.rmsnorm_error_string(rc).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed: {msg} (cudaError {rc})")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
