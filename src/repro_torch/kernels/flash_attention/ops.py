"""Wrapper of the flash-attention forward kernels.

``flash_attention(q, k, v, causal)`` takes the reference's layout, q
(B,Hq,S,D) and k, v (B,Hkv,T,D), and returns (B,Hq,S,D) in ``q.dtype``.  On
CUDA tensors it launches a hand-written kernel (built with nvcc at first
use) or raises, the kernel fixed by dtype and head dim (:func:`route`):

* bf16 at D in {64, 128, 192}: the tensor cores, ``csrc/flash_attention_sm90.cu``
  (wgmma and TMA);
* fp32 at every D, and bf16 at D in {16, 32}: the CUDA cores,
  ``csrc/flash_attention.cu`` (exact fp32 arithmetic).

A failed build or launch raises; no call gives way to the other kernel or
to the plain version, which
(:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`) it takes
only for tensors on the CPU.  ``flash_attention.launches`` counts launches
of both kernels.

The kernels are forward-only, as the reference's Pallas kernel is (it defines
no VJP, and ``jax.grad`` through it fails): with grad enabled, an input that
requires grad is refused on both devices rather than differentiated through
the plain version.

A fake tensor that stands for the card (:mod:`repro_torch.kernels.cost`)
gets a fake output and reports :func:`cost` to the op counter; nothing
launches.

What the reference's wrapper does by padding, the kernels do with bounds
masks: GQA reads kv head ``h // (Hq // Hkv)`` in place of ``repeat``, and
ragged S and T need no padding.  As in the reference (``ops.py:36-41``),
non-causal attention over a key length that is not a multiple of its
128-key block (when longer than one block) is refused.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import Built, load_cuda_library
from repro_torch.kernels.cost import KernelCost, record, stands_for_card
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"  # CUDA cores
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "flash_attention_sm90.cu"  # tensor cores
HEAD_DIMS = (16, 32, 64, 128, 192)
TENSOR_CORE_HEAD_DIMS = (64, 128, 192)  # bf16 only
REF_BLOCK_K = 128  # the reference's key block, which sets its padding rule
MAX_BH = 65535  # gridDim.y of the CUDA-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTRS_AND_SHAPE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
_LONGS = ctypes.POINTER(ctypes.c_longlong)


def _declare(built: Built, fn_name: str, argtypes: list, err_name: str) -> Built:
    fn = getattr(built.lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(built.lib, err_name)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built


def build_cuda_core() -> Built:
    """Compile (once) and load the CUDA-core kernel; declares the C signature."""
    return _declare(load_cuda_library("flash_attention", SOURCE), "flash_attention_fwd",
                    _PTRS_AND_SHAPE + [_LONGS, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                    "flash_attention_error_string")


def build_tensor_core() -> Built:
    """Compile (once) and load the tensor-core kernel; declares the C signature."""
    built = _declare(load_cuda_library("flash_attention_sm90", SOURCE_SM90),
                     "flash_attention_fwd_sm90",
                     _PTRS_AND_SHAPE + [_LONGS, _LONGS, ctypes.c_int, ctypes.c_void_p],
                     "flash_attention_sm90_error_string")
    built.lib.flash_attention_sm90_smem_bytes.argtypes = [ctypes.c_int]
    return built


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a CUDA call takes: ``"tensor_core"`` or ``"cuda_core"``."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def cost(q_shape, kv_shape, dtype: torch.dtype, causal: bool = True) -> KernelCost:
    """A launch at q (B,Hq,S,D), k and v (B,Hkv,T,D): q k^T and p v, 4 D
    flops a (query, key) pair, over the causal triangle (S T - S^2/2 pairs
    a head) or the whole S T; q, k, v read once and the output written
    once; on the tensor cores (bf16) or the CUDA cores (fp32), as
    :func:`route` sends it."""
    B, Hq, S, D = q_shape
    Hkv, T = kv_shape[1], kv_shape[2]
    pairs = S * T - S * S / 2 if causal else S * T
    flops = 4.0 * B * Hq * D * pairs
    nbytes = B * (2 * Hq * S + 2 * Hkv * T) * D * dtype.itemsize
    return KernelCost(flops, nbytes, "bf16" if route(dtype, D) == "tensor_core" else "fp32")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, H, S, D), got {tuple(t.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention is forward-only (the reference's kernel has no VJP); "
            "run it under torch.no_grad() or use attention_impl='ref' to train")
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k, v must be (B, Hkv, T, D) matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    Hkv, T = k.shape[1], k.shape[2]
    if min(B, Hq, S, T) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} must be a multiple of kv heads {Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel takes {HEAD_DIMS}")
    if causal and S > T:
        raise ValueError(f"causal attention needs S <= T, got S={S}, T={T}")
    if not causal and T > REF_BLOCK_K and T % REF_BLOCK_K:
        raise ValueError(f"non-causal attention over T={T} keys, not a multiple of "
                         f"{REF_BLOCK_K}: the reference refuses its key padding")


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """A view the kernels can read through its strides: the last dimension
    contiguous, every other stride a positive multiple of 16 bytes (as a
    tensor map needs; a dimension of size 1 is never stepped) and the base
    16-byte aligned; otherwise a contiguous copy."""
    align = 16 // t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or (s > 0 and s % align == 0)
                    for s, n in zip(t.stride()[:3], t.shape[:3]))):
        return t
    return t.contiguous()


def _tensor_map(t: torch.Tensor) -> list:
    """The 4-D TMA map of a (B, H, L, D) view as the tensor-core kernel takes
    it: sizes (D, then rows, heads and batch in the order of their strides,
    a dimension of size 1 last), the three outer byte strides, and the
    places of rows, heads and batch among the outer three."""
    span = max(t.stride(i) * t.shape[i] for i in range(4))
    stride = [t.stride(i) if t.shape[i] > 1 else span for i in range(3)]
    order = sorted((2, 1, 0), key=lambda i: stride[i])  # rows, heads, batch by stride
    return ([t.shape[3]] + [t.shape[i] for i in order]
            + [stride[i] * t.element_size() for i in order]
            + [order.index(i) for i in (2, 1, 0)])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B,Hq,S,D), k/v (B,Hkv,T,D) -> (B,Hq,S,D) in ``q.dtype``."""
    _check(q, k, v, causal)
    card = stands_for_card(q)
    if q.device.type == "cpu" and not card:
        return attention_ref(q, k, v, causal)
    if q.device.type != "cuda" and not card:
        raise ValueError(f"flash_attention runs on 'cuda' or 'cpu' tensors, got {q.device}")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    tensor_core = route(q.dtype, D) == "tensor_core"
    if not tensor_core and B * Hq > MAX_BH:
        raise ValueError(f"B*Hq = {B * Hq} exceeds the kernel's grid ({MAX_BH})")
    # the output is laid out (B,S,Hq,D), as the model consumes it, and
    # returned as the (B,Hq,S,D) view
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if card:
        return record("flash_attention", cost(q.shape, k.shape, q.dtype, causal), out)
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, T, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tensor_core:
            lib, err = build_tensor_core().lib, "flash_attention_sm90_error_string"
            maps = (ctypes.c_longlong * 30)(*(x for t in (q, k, v) for x in _tensor_map(t)))
            ostrides = (ctypes.c_longlong * 3)(*out.stride()[:3])
            rc = lib.flash_attention_fwd_sm90(*args, maps, ostrides, int(causal), stream)
        else:
            lib, err = build_cuda_core().lib, "flash_attention_error_string"
            strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
            rc = lib.flash_attention_fwd(*args, strides, int(causal), _DTYPES[q.dtype], stream)
    if rc != 0:
        msg = getattr(lib, err)(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (code {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
