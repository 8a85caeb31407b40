"""Op-level cost of a program as the port dispatches it (the counterpart of
the reference's ``repro/launch/hlo_cost.py``).

The reference costs a compiled, fused HLO module.  The port has no such
module: it runs a sequence of aten ops and four ctypes-bound kernels.  So
:class:`OpCounter`, a ``TorchDispatchMode``, counts the ops as they
dispatch, usually on fake tensors (``FakeTensorMode``: shapes and dtypes,
no storage), so a full-width, full-depth step is counted on a host with no
card and no memory to hold it:

- **FLOPs**: the matmul-class ops, by ``torch.utils.flop_counter``'s
  formulas (mm, addmm, bmm, baddbmm, convolution forward and backward,
  scaled-dot-product attention), as ``hlo_cost`` counts dot and
  convolution only; and each kernel's registered operations.  Each is
  filed under the compute class whose peak bounds it
  (:mod:`repro_torch.launch.roofline`): bf16/fp16 inputs on the tensor
  cores; fp32 convolutions in TF32 when ``cudnn.allow_tf32`` is on and
  fp32 matmuls when ``cuda.matmul.allow_tf32`` is on (the flags in force
  when the counter is entered), else on the CUDA cores.
- **Bytes**: an eager op materialises its result, so each op reads its
  inputs once and writes its outputs once, counted on the elements a view
  spans (a broadcast dimension once).  Views and metadata ops move
  nothing.  A gather (``embedding``, ``index_select``, ``gather``,
  ``index``) reads its indices and the rows it returns, not the whole
  table.  An in-place write into part of a buffer (``copy_`` into a
  slice, ``index_copy_``, ``index_put_``, ``scatter_``: the KV-cache write)
  counts the written part, not the buffer: the reference's in-place
  dynamic-update-slice rule.  A kernel counts its registered bytes.
- **Collectives**: ops under ``torch.ops._c10d_functional`` add their wire
  bytes by the ring factors of :func:`repro_torch.launch.roofline.wire_bytes`.
- **Live bytes**: the peak of the bytes of live storages, each counted
  from the op that created it until it dies (weak references, swept when
  the total would pass the peak), over the tensors :meth:`OpCounter.adopt`
  was given and everything the program made: the stand-in for the
  reference's ``compiled.memory_analysis()``.

Where the reference's XLA fuses, the port's eager ops each go to memory, so
the port's bytes are larger: that is what the port moves.  FLOPs agree
across the packages (``tests/test_torch_roofline.py``).

A program is counted for the card on fake CPU tensors, under
:func:`repro_torch.kernels.cost.for_card`, so each kernel wrapper counts
its kernel as it would on the card, on every host (a fake CUDA tensor can
be indexed and differentiated only on a build of PyTorch with CUDA).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch.roofline import wire_bytes
from repro_torch.tree import leaves

aten = torch.ops.aten

# ops that move nothing though their schema does not say so
_NO_TRAFFIC = {
    aten._unsafe_view.default, aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default, aten.new_empty_strided.default,
    aten.lift_fresh.default, aten.resize_.default,
}
# in-place ops that overwrite (the part they address of) their
# destination without reading it
_OVERWRITE = {
    aten.copy_, aten.fill_, aten.zero_, aten.normal_, aten.uniform_, aten.random_,
    aten.bernoulli_, aten.exponential_, aten.index_copy_, aten.index_put_, aten.scatter_,
    aten.scatter_add_, aten.index_add_,
}
# gathers: what they read is their indices and the rows they return
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index}
_CONV = {
    "convolution", "_convolution", "cudnn_convolution", "convolution_overrideable",
    "_slow_conv2d_forward", "convolution_backward",
}
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce", "all_to_all_single": "all-to-all",
}


def span_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a view spans, a broadcast (stride-0)
    dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    """A functional op whose every tensor result aliases an input."""
    schema = func._schema
    if schema.is_mutable or not schema.returns:
        return False
    return all(r.alias_info is not None and not r.alias_info.is_write for r in schema.returns)


def _mutated(func, args, kwargs) -> List[torch.Tensor]:
    """The tensor arguments an op writes in place (``self`` of ``add_``,
    ``out=`` of an out variant)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = kwargs.get(a.name, args[i] if i < len(args) and not a.kwarg_only else None)
        out.extend(_tensors(v))
    return out


def _has_out(func) -> bool:
    """An ``out=`` variant: its written arguments are keyword-only."""
    return any(a.kwarg_only and a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


def _written(func, args, dst: torch.Tensor) -> int:
    """Bytes an overwrite puts into ``dst``: the part it addresses."""
    item = dst.element_size()
    packet = func._overloadpacket
    if packet in (aten.index_copy_, aten.index_add_):
        return args[3].numel() * item
    if packet in (aten.scatter_, aten.scatter_add_):
        return args[2].numel() * item
    if packet is aten.index_put_:
        idx = [i for i in args[1] if i is not None]
        n = math.prod(torch.broadcast_shapes(*(i.shape for i in idx))) if idx else 1
        indexed = len(args[1])
        return max(n * math.prod(dst.shape[indexed:]), _tensors(args[2])[0].numel()) * item
    return span_bytes(dst)


_COMPOSITE: Dict[Any, bool] = {}


def _composite_only(func) -> bool:
    """Is ``func`` only a composition of other ops, with no kernel of its
    own on any backend?"""
    hit = _COMPOSITE.get(func)
    if hit is None:
        if func.namespace != "aten":
            _COMPOSITE[func] = False
            return False
        name = func.name()
        has = torch._C._dispatch_has_kernel_for_dispatch_key
        hit = _COMPOSITE[func] = (
            has(name, "CompositeImplicitAutograd")
            and not any(has(name, k) for k in ("CPU", "CUDA", "CompositeExplicitAutograd")))
    return hit


def _compute_class(func, tensors: List[torch.Tensor], flags: Dict[str, bool]) -> str:
    dtype = tensors[0].dtype if tensors else torch.float32
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        conv = func._overloadpacket.__name__ in _CONV
        if flags["cudnn_allow_tf32" if conv else "matmul_allow_tf32"]:
            return "tf32"
    return "fp32"


def _group_size(name: str, args) -> int:
    if name in ("all_gather_into_tensor", "all_gather_into_tensor_out"):
        return int(args[1])
    if name == "reduce_scatter_tensor":
        return int(args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


class LiveBytes:
    """The peak of the bytes of live storages.  A storage is counted once,
    from the first tensor that shows it until it dies; the dead are swept
    when the total would pass the peak, so the peak is exact and most ops
    cost a dict lookup."""

    def __init__(self) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef

        self._ref = StorageWeakRef
        self._entries: Dict[int, Tuple[Any, int]] = {}
        self.live = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        old = self._entries.get(key)
        if old is not None:
            if not old[0].expired():
                return
            self.live -= old[1]  # a dead storage's address, reused
        nbytes = storage.nbytes()
        self._entries[key] = (self._ref(storage), nbytes)
        self.live += nbytes
        if self.live > self.peak:
            self.sweep()
            self.peak = max(self.peak, self.live)

    def sweep(self) -> None:
        for key, (ref, nbytes) in list(self._entries.items()):
            if ref.expired():
                del self._entries[key]
                self.live -= nbytes


@dataclass
class ModuleCost:
    """What a counted program cost: the reference ``ModuleCost``'s fields,
    then the port's."""
    flops: float
    traffic_bytes: float
    wire_bytes: float
    wire_by_kind: Dict[str, float]
    coll_count: Dict[str, int]
    flops_by_class: Dict[str, float] = field(default_factory=dict)
    kernels: Dict[str, int] = field(default_factory=dict)  # fake launches by kernel
    ops: int = 0  # ops dispatched
    top_flops: List[Dict[str, Any]] = field(default_factory=list)
    top_bytes: List[Dict[str, Any]] = field(default_factory=list)
    start_live_bytes: int = 0
    peak_live_bytes: int = 0
    flags: Dict[str, bool] = field(default_factory=dict)
    per_op: Dict[str, List[float]] = field(default_factory=dict)  # name -> [calls, flops, bytes]


class OpCounter(TorchDispatchMode):
    """Count FLOPs by compute class, bytes, wire bytes, kernel launches and
    live bytes of everything dispatched inside; :meth:`cost` sums them."""

    def __init__(self, *, top: int = 12) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self._top = top
        self.flops_by_class: Dict[str, float] = {}
        self.traffic = 0.0
        self.wire_by_kind: Dict[str, float] = {}
        self.coll_count: Dict[str, int] = {}
        self.kernels: Dict[str, int] = {}
        self.per_op: Dict[str, List[float]] = {}  # name -> [calls, flops, bytes]
        self.ops = 0
        self.live = LiveBytes()
        self.start_live = 0
        self.flags: Dict[str, bool] = {}
        self._sink = None
        self._depth = 0

    def adopt(self, *trees: Any) -> "OpCounter":
        """Count the tensors of ``trees`` as live from the start (the train
        state, the batch, the cache)."""
        for tree in trees:
            for t in leaves(tree):
                if isinstance(t, torch.Tensor):
                    self.live.add(t)
        self.start_live = self.live.live
        return self

    def __enter__(self):
        if not self._depth:
            self.flags = {"matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
                          "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}
            self._sink = kernel_cost.sink(self._kernel)
            self._sink.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                self._sink.__exit__(*exc)

    def _tally(self, name: str, flops: float, nbytes: float, cls: Optional[str]) -> None:
        self.ops += 1
        rec = self.per_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self.traffic += nbytes
        if flops:
            self.flops_by_class[cls] = self.flops_by_class.get(cls, 0.0) + flops

    def _kernel(self, name: str, c: kernel_cost.KernelCost) -> None:
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self._tally(f"kernel:{name}", c.flops, c.bytes, c.compute_class)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite_only(func):
            # a composite op (einsum, matmul, linear, softmax) reaches the
            # mode whole under inference_mode: count what it runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.live.add(t)
        if not outs or func in _NO_TRAFFIC or _is_view(func):
            return out
        ins = _tensors((args, kwargs))
        name = func.__name__ if func.namespace == "aten" else f"{func.namespace}.{func.__name__}"
        flops, cls = 0.0, None
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            cls = _compute_class(func, ins, self.flags)
        mutated = _mutated(func, args, kwargs)
        if func._overloadpacket in _GATHERS:
            nbytes = sum(span_bytes(t) for t in ins[1:]) + sum(span_bytes(t) for t in outs)
        elif mutated:
            keep = [t for t in ins if not any(t is m for m in mutated)]
            if func._overloadpacket in _OVERWRITE or _has_out(func):
                nbytes = (sum(span_bytes(t) for t in keep)
                          + sum(_written(func, args, m) for m in mutated))
            else:  # read-modify-write (add_, mul_, ...)
                nbytes = sum(span_bytes(t) for t in ins) + sum(span_bytes(m) for m in mutated)
        else:
            nbytes = sum(span_bytes(t) for t in ins) + sum(span_bytes(t) for t in outs)
        if func.namespace == "_c10d_functional" and func.__name__.split(".")[0] in _COLLECTIVES:
            base = func.__name__.split(".")[0]
            kind = _COLLECTIVES[base]
            w = wire_bytes(kind, sum(t.numel() * t.element_size() for t in outs),
                           _group_size(base, args))
            self.wire_by_kind[kind] = self.wire_by_kind.get(kind, 0.0) + w
            self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
        self._tally(name, flops, nbytes, cls)
        return out

    def cost(self) -> ModuleCost:
        self.live.sweep()
        rows = [{"op": k, "calls": int(v[0]), "flops": v[1], "bytes": v[2]}
                for k, v in self.per_op.items()]
        top_f = sorted((r for r in rows if r["flops"]), key=lambda r: -r["flops"])[:self._top]
        top_b = sorted(rows, key=lambda r: -r["bytes"])[:self._top]
        return ModuleCost(
            flops=sum(self.flops_by_class.values()), traffic_bytes=self.traffic,
            wire_bytes=sum(self.wire_by_kind.values()), wire_by_kind=dict(self.wire_by_kind),
            coll_count=dict(self.coll_count), flops_by_class=dict(self.flops_by_class),
            kernels=dict(self.kernels), ops=self.ops, top_flops=top_f, top_bytes=top_b,
            start_live_bytes=self.start_live, peak_live_bytes=self.live.peak,
            flags=dict(self.flags), per_op={k: list(v) for k, v in self.per_op.items()})


def count(fn, *args: Any, adopt: Tuple[Any, ...] = (), **kwargs: Any) -> Tuple[Any, ModuleCost]:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`OpCounter` that
    adopts ``adopt`` (default: the arguments) as live; returns (result,
    cost)."""
    counter = OpCounter().adopt(*(adopt or (args, kwargs)))
    with counter:
        result = fn(*args, **kwargs)
    return result, counter.cost()


def fake_mode():
    """A new ``FakeTensorMode``: tensors made inside it have a shape, a dtype
    and a device and no storage.  Enter it to build or run a program; pass
    it on (``specs``) to build more of the same program's tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()
