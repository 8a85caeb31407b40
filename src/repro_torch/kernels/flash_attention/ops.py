"""Wrappers of the flash-attention kernels, forward and backward.

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

``flash_attention`` is forward-only, as the reference's Pallas kernel is (it
defines no VJP, and ``jax.grad`` through it fails): with grad enabled, an
input that requires grad is refused on both devices rather than
differentiated through the plain version.  Training goes through
:func:`attention` instead: causal self-attention (S == T) in bf16 at D in
``TENSOR_CORE_HEAD_DIMS``, a ``torch.autograd.Function`` whose forward is
the tensor-core kernel storing each row's log-sum-exp and whose backward is
``csrc/flash_attention_bwd_sm90.cu`` (:func:`flash_attention_bwd`, which the
reference has no counterpart of; ``flash_attention_bwd.launches`` counts
its calls).  On CPU tensors both halves take their plain versions.

A fake tensor that stands for the card (:mod:`repro_torch.kernels.cost`)
gets a fake output and reports :func:`cost` (the backward
:func:`cost_bwd`) to the op counter; nothing launches.

What the reference's wrapper does by padding, the kernels do with bounds
masks: GQA reads kv head ``h // (Hq // Hkv)`` in place of ``repeat``, and
ragged S and T need no padding.  As in the reference (``ops.py:36-41``),
non-causal attention over a key length that is not a multiple of its
128-key block (when longer than one block) is refused.
"""
from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import Built, load_cuda_library
from repro_torch.kernels.cost import KernelCost, record, stands_for_card
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"  # CUDA cores
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "flash_attention_sm90.cu"  # tensor cores
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd_sm90.cu"  # its backward
HEAD_DIMS = (16, 32, 64, 128, 192)
TENSOR_CORE_HEAD_DIMS = (64, 128, 192)  # bf16 only
REF_BLOCK_K = 128  # the reference's key block, which sets its padding rule
BWD_BLOCK_Q = 64  # the backward's q tile: lse rows are padded to a multiple of it
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
                     _PTRS_AND_SHAPE + [_LONGS, _LONGS, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
                     "flash_attention_sm90_error_string")
    built.lib.flash_attention_sm90_smem_bytes.argtypes = [ctypes.c_int]
    return built


def build_backward() -> Built:
    """Compile (once) and load the tensor-core backward; declares the C signature."""
    built = _declare(load_cuda_library("flash_attention_bwd_sm90", SOURCE_BWD),
                     "flash_attention_bwd_sm90",
                     [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                     + [ctypes.c_longlong, _LONGS, _LONGS, ctypes.c_int, ctypes.c_void_p],
                     "flash_attention_bwd_sm90_error_string")
    built.lib.flash_attention_bwd_sm90_smem_bytes.argtypes = [ctypes.c_int]
    return built


def build_training() -> None:
    """Build the forward and the backward sources at once (two nvcc
    processes), so the first training call waits for the longer of the two
    builds, not for their sum; later calls return at once."""
    if not build_training.done:
        with ThreadPoolExecutor(1) as pool:
            bwd = pool.submit(build_backward)
            build_tensor_core()
            bwd.result()
        build_training.done = True


build_training.done = False


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a CUDA call takes: ``"tensor_core"`` or ``"cuda_core"``."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def _pairs(S: int, T: int, causal: bool) -> float:
    """(query, key) pairs a head computes: the causal triangle or all S T."""
    return S * T - S * S / 2 if causal else S * T


def cost(q_shape, kv_shape, dtype: torch.dtype, causal: bool = True,
         train: bool = False) -> KernelCost:
    """A launch at q (B,Hq,S,D), k and v (B,Hkv,T,D): q k^T and p v, 4 D
    flops a (query, key) pair, over the causal triangle (S T - S^2/2 pairs
    a head) or the whole S T; q, k, v read once and the output written
    once, and for training (``train``) what its rounding lost and each
    row's fp32 log-sum-exp; on the tensor cores (bf16) or the CUDA cores
    (fp32), as :func:`route` sends it."""
    B, Hq, S, D = q_shape
    Hkv, T = kv_shape[1], kv_shape[2]
    flops = 4.0 * B * Hq * D * _pairs(S, T, causal)
    nbytes = (B * ((3 if train else 2) * Hq * S + 2 * Hkv * T) * D * dtype.itemsize
              + (4 * B * Hq * S if train else 0))
    return KernelCost(flops, nbytes, "bf16" if route(dtype, D) == "tensor_core" else "fp32")


def cost_bwd(q_shape, kv_shape, dtype: torch.dtype = torch.bfloat16,
             causal: bool = True) -> KernelCost:
    """A backward call at q (B,Hq,S,D), k and v (B,Hkv,T,D): five products
    of 2 D flops a (query, key) pair (q k^T and do v^T again, p^T do, ds^T q,
    ds k) over the causal triangle or the whole S T, on the tensor cores; q,
    o and what its rounding lost, do and lse read once, k and v read once,
    dq, dk and dv written once (the fp32 scratch of delta and of dq's sums
    left out)."""
    B, Hq, S, D = q_shape
    Hkv, T = kv_shape[1], kv_shape[2]
    flops = 10.0 * B * Hq * D * _pairs(S, T, causal)
    nbytes = B * (5 * Hq * S + 4 * Hkv * T) * D * dtype.itemsize + 4 * B * Hq * S
    return KernelCost(flops, nbytes, "bf16")


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
    return _forward(q, k, v, causal)[0]


def _padded(S: int) -> int:
    """The lse row length the backward reads: S up to its q tile."""
    return -(-S // BWD_BLOCK_Q) * BWD_BLOCK_Q


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             train: bool = False):
    """(output, lse, o_lo) of checked inputs.  For ``train`` (the
    tensor-core route only) the kernel also stores each row's log-sum-exp,
    (B,Hq,S) fp32, as a view of rows padded to :func:`_padded`, and what
    the output's bf16 rounding lost, laid out as the output; otherwise
    both are None.  On the CPU: the plain version, o_lo None."""
    card = stands_for_card(q)
    if q.device.type == "cpu" and not card:
        if train:
            return (*attention_ref(q, k, v, causal, with_lse=True), None)
        return attention_ref(q, k, v, causal), None, None
    if q.device.type != "cuda" and not card:
        raise ValueError(f"flash_attention runs on 'cuda' or 'cpu' tensors, got {q.device}")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    tensor_core = route(q.dtype, D) == "tensor_core"
    if train and not tensor_core:
        raise ValueError(f"the log-sum-exp is stored by the tensor-core kernel only "
                         f"(bf16 at D in {TENSOR_CORE_HEAD_DIMS}), got {q.dtype} at D={D}")
    if not tensor_core and B * Hq > MAX_BH:
        raise ValueError(f"B*Hq = {B * Hq} exceeds the kernel's grid ({MAX_BH})")
    # the output is laid out (B,S,Hq,D), as the model consumes it, and
    # returned as the (B,Hq,S,D) view
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = o_lo = None
    if train:
        lse = torch.empty((B, Hq, _padded(S)), dtype=torch.float32, device=q.device)[..., :S]
        o_lo = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if card:
        return record("flash_attention", cost(q.shape, k.shape, q.dtype, causal, train),
                      (out, lse, o_lo))
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, T, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tensor_core:
            lib, err = build_tensor_core().lib, "flash_attention_sm90_error_string"
            maps = (ctypes.c_longlong * 30)(*(x for t in (q, k, v) for x in _tensor_map(t)))
            ostrides = (ctypes.c_longlong * 3)(*out.stride()[:3])
            rc = lib.flash_attention_fwd_sm90(
                *args, maps, ostrides, None if o_lo is None else o_lo.data_ptr(),
                None if lse is None else lse.data_ptr(), 0 if lse is None else lse.stride(1),
                int(causal), stream)
        else:
            lib, err = build_cuda_core().lib, "flash_attention_error_string"
            strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
            rc = lib.flash_attention_fwd(*args, strides, int(causal), _DTYPES[q.dtype], stream)
    if rc != 0:
        msg = getattr(lib, err)(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (code {rc})")
    flash_attention.launches += 1
    return out, lse, o_lo


flash_attention.launches = 0


def _lse_ready(lse: torch.Tensor) -> torch.Tensor:
    """lse (B,Hq,S) fp32 as the backward reads it: rows contiguous, each
    starting on 16 bytes and at least :func:`_padded` long (the forward's
    own lse is such a view); otherwise copied into one."""
    B, Hq, S = lse.shape
    ls = lse.stride(1)
    if (lse.dtype == torch.float32 and lse.stride(2) == 1 and ls % 4 == 0
            and ls >= _padded(S) and lse.stride(0) == Hq * ls and lse.data_ptr() % 16 == 0
            and lse.storage_offset() + B * Hq * ls <= lse.untyped_storage().nbytes() // 4):
        return lse
    out = torch.empty((B, Hq, _padded(S)), dtype=torch.float32, device=lse.device)
    out[..., :S] = lse
    return out[..., :S]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        o_lo: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal)`` at upstream
    gradient ``do`` (B,Hq,S,D), given its output ``o``, log-sum-exp ``lse``
    (B,Hq,S) and, optionally, what o's rounding lost (``o_lo``, laid out as
    o), which rowsum(do o) then adds.  On CUDA tensors: bf16 at D in
    ``TENSOR_CORE_HEAD_DIMS`` only, through the tensor-core backward; dq is
    laid out (B,S,Hq,D) and dk, dv (B,T,Hkv,D), as the model's projections,
    and returned as (B,H,L,D) views.  On the CPU: the plain version."""
    card = stands_for_card(q)
    if q.device.type == "cpu" and not card:
        return attention_bwd_ref(q, k, v, o, lse, do, causal, o_lo=o_lo)
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if route(q.dtype, D) != "tensor_core" or not (k.dtype == v.dtype == o.dtype == do.dtype
                                                   == q.dtype):
        raise ValueError(f"the backward kernel takes bf16 at D in {TENSOR_CORE_HEAD_DIMS}, got "
                         f"{q.dtype} at D={D}")
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (B, Hq, S):
        raise ValueError(f"o and do must be {tuple(q.shape)} and lse {(B, Hq, S)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)} and {tuple(lse.shape)}")
    dq = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, T, Hkv, D), dtype=k.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, T, Hkv, D), dtype=v.dtype, device=q.device).transpose(1, 2)
    if card:
        return record("flash_attention_bwd", cost_bwd(q.shape, k.shape, q.dtype, causal),
                      (dq, dk, dv))
    lse = _lse_ready(lse)
    ls = lse.stride(1)
    q, k, v, o, do = (_kernel_ready(t) for t in (q, k, v, o, do))
    if o_lo is not None and (o_lo.shape != o.shape or o_lo.dtype != o.dtype):
        raise ValueError(f"o_lo must be o's shape and type, got {tuple(o_lo.shape)} {o_lo.dtype}")
    if o_lo is not None and o_lo.stride() != o.stride():  # the delta kernel reads both alike
        o, o_lo = o.contiguous(), o_lo.contiguous()
    delta = torch.empty((B, Hq, ls), dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros(B * Hq * ls * D, dtype=torch.float32, device=q.device)
    maps = (ctypes.c_longlong * 40)(*(x for t in (q, k, v, do) for x in _tensor_map(t)))
    strides = (ctypes.c_longlong * 15)(*(s for t in (o, do, dq, dk, dv) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib = build_backward().lib
        rc = lib.flash_attention_bwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if o_lo is None else o_lo.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, Hq, Hkv, S, T, D, ls, maps, strides, int(causal), stream)
    if rc != 0:
        msg = lib.flash_attention_bwd_sm90_error_string(rc).decode()
        raise RuntimeError(f"flash_attention backward launch failed: {msg} (code {rc})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _Attention(torch.autograd.Function):
    """Causal attention whose forward stores each row's log-sum-exp and
    whose backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cuda":
            build_training()
        out, lse, o_lo = _forward(q, k, v, True, train=True)
        ctx.save_for_backward(q, k, v, out, lse, o_lo)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, o_lo = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, do, o_lo=o_lo)


def takes_training_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Does causal self-attention over these (B,H,L,D) inputs go through
    :func:`attention`: q on the card (or a fake tensor standing for it),
    bf16 throughout, D in ``TENSOR_CORE_HEAD_DIMS``, k and v alike and S ==
    T?  The caller has checked the rest (causal, no cache)."""
    return ((q.device.type == "cuda" or stands_for_card(q))
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] in TENSOR_CORE_HEAD_DIMS and k.shape == v.shape
            and q.shape[2] == k.shape[2])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention q (B,Hq,S,D), k, v (B,Hkv,S,D) -> (B,Hq,S,D),
    differentiable: with grad enabled and an input that requires grad,
    through the autograd Function (forward kernel with lse, backward
    kernel); otherwise :func:`flash_attention`'s forward launch."""
    _check_train(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v)
    return _forward(q, k, v, True)[0]


def _check_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    with torch.no_grad():  # the forward-only refusal is flash_attention's, not this route's
        _check(q, k, v, True)
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"attention is self-attention (S == T), got S={q.shape[2]}, "
                         f"T={k.shape[2]}")
