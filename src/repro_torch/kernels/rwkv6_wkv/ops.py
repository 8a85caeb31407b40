"""Wrapper of the RWKV-6 WKV kernel, in the model layer's calling convention.

``wkv(r, k, v, w, u, s0)`` takes r, k, v, w (B,S,H,D) fp32, u (H,D) and s0
(B,H,D,D), and returns y (B,S,H,D) and the final state sT (B,H,D,D), as the
reference's wrapper (``repro/kernels/rwkv6_wkv/ops.py``) does.  On CUDA
tensors it launches the hand-written kernel in ``csrc/wkv.cu`` (built with
nvcc at first use) or raises; it takes the plain version
(:func:`~repro_torch.kernels.rwkv6_wkv.ref.wkv_plain`) only for tensors on the
CPU.  ``wkv.launches`` counts kernel launches.

What the reference's wrapper does around its chunked TPU kernel, the kernel
does without: it reads (B,S,H,D) in place through its strides (no transpose
to (BH,S,D)), runs the per-token recurrence so any S needs no padding, and
loads a nonzero s0 into its state registers (no analytic fold).  It has no
chunks, so it takes no ``chunk`` argument.  A lane holds C columns of the
state and 1/G of their rows, one (G, C) for each head dim (:data:`LAYOUT`).

A fake tensor that stands for the card (:mod:`repro_torch.kernels.cost`)
gets fake outputs and reports :func:`cost` to the op counter; nothing
launches.

The kernel is forward-only, as the reference's Pallas kernel is (it defines
no VJP, and ``jax.grad`` through it fails): with grad enabled, an input that
requires grad is refused on both devices.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import Built, load_cuda_library
from repro_torch.kernels.cost import KernelCost, record, stands_for_card
from repro_torch.kernels.rwkv6_wkv.ref import wkv_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"
# The kernel csrc/wkv.cu builds for each head dim D (its WKV_CASES), as
# (G, C): a lane holds C columns of the state and 1/G of their rows.
LAYOUT = {8: (2, 4), 16: (4, 4), 32: (8, 4), 64: (4, 4), 128: (16, 8)}
HEAD_DIMS = tuple(LAYOUT)


def build() -> Built:
    """Compile (once) and load the kernel library; declares the C signature."""
    built = load_cuda_library("rwkv6_wkv", SOURCE)
    fn = built.lib.wkv_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = built.lib.wkv_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        occ.restype = ctypes.c_int
        err = built.lib.wkv_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built


def occupancy(D: int) -> dict:
    """Resident blocks an SM of the kernel for head dim D, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives it, with its
    threads a block and dynamic shared bytes.  Needs the card."""
    G, C = LAYOUT[D]
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    n = build().lib.wkv_occupancy(D, G, C, ctypes.byref(threads), ctypes.byref(smem))
    if n <= 0:
        raise RuntimeError(f"wkv occupancy of D={D}, G={G}, C={C}: error {n}")
    return {"D": D, "G": G, "C": C, "threads": threads.value, "dynamic_smem_bytes": smem.value,
            "blocks_per_sm": n, "warps_per_sm": n * -(-threads.value // 32)}


def cost(B: int, S: int, H: int, D: int) -> KernelCost:
    """A launch at r, k, v, w (B,S,H,D): 5 D^2 flops a token and head (D
    fmas for y, a multiply and an fma for S) on the fp32 CUDA cores; r, k,
    v, w, y (B,S,H,D), s0 and sT (B,H,D,D) and u (H,D) in fp32, each moved
    once."""
    flops = 5.0 * D * D * B * S * H
    return KernelCost(flops, 4 * (5 * B * S * H * D + 2 * B * H * D * D + H * D), "fp32")


def _check(r, k, v, w, u, s0) -> None:
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in named):
        raise RuntimeError(
            "wkv is forward-only (the reference's kernel has no VJP); run it under "
            "torch.no_grad() or train through the model's plain scan")
    if r.dim() != 4:
        raise ValueError(f"r must be 4-D (B, S, H, D), got {tuple(r.shape)}")
    B, S, H, D = r.shape
    for name, t in named[1:4]:
        if t.shape != r.shape:
            raise ValueError(f"{name} must match r {tuple(r.shape)}, got {tuple(t.shape)}")
    if u.shape != (H, D):
        raise ValueError(f"u must be (H, D) = {(H, D)}, got {tuple(u.shape)}")
    if s0.shape != (B, H, D, D):
        raise ValueError(f"s0 must be (B, H, D, D) = {(B, H, D, D)}, got {tuple(s0.shape)}")
    if min(B, S, H) == 0:
        raise ValueError(f"empty input: r {tuple(r.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel takes {HEAD_DIMS}")


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """A view the kernel can read through its strides with 16-byte loads: the
    last dimension contiguous and every token row 16-byte aligned; otherwise
    a contiguous copy."""
    if t.stride(3) == 1 and all(s % 4 == 0 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w (B,S,H,D), u (H,D), s0 (B,H,D,D), fp32 -> y (B,S,H,D), sT (B,H,D,D)."""
    _check(r, k, v, w, u, s0)
    if stands_for_card(r):
        B, S, H, D = r.shape
        y = torch.empty((B, S, H, D), dtype=torch.float32, device=r.device)
        sT = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
        return record("rwkv6_wkv", cost(B, S, H, D), (y, sT))
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv runs on 'cuda' or 'cpu' tensors, got {r.device}")
    return _launch(r, k, v, w, u, s0)


def _launch(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors that :func:`wkv` has checked;
    raises if the launch fails."""
    B, S, H, D = r.shape
    G, C = LAYOUT[D]
    lib = build().lib
    r, k, v, w = (_kernel_ready(t) for t in (r, k, v, w))
    u, s0 = u.contiguous(), s0.contiguous()
    y = torch.empty((B, S, H, D), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (r, k, v, w) for s in t.stride()[:3]))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                         s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, S, H, D, G, C,
                         strides, stream)
    if rc != 0:
        msg = lib.wkv_error_string(rc).decode()
        raise RuntimeError(f"wkv kernel launch failed: {msg} (cudaError {rc})")
    wkv.launches += 1
    return y, sT


wkv.launches = 0
