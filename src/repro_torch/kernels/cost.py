"""What a kernel costs, as its wrapper reports it to an op counter.

Each kernel's ``ops.py`` states its work from its shapes: the operations it
does, the bytes it must move (each input read once, each output written
once) and the compute class whose peak bounds those operations (``"bf16"``
for the tensor cores in bf16/fp16, ``"tf32"``, ``"fp32"`` for the CUDA
cores).  chip_smoke's ``bound_ms`` and the dry run's roofline
(:mod:`repro_torch.launch.op_cost`) read the same numbers.

A wrapper given a fake tensor (``FakeTensorMode``: a shape and a dtype, no
storage) that stands for the card returns a fake output of the right shape
and tells the active counter, through :func:`record`, that one launch of
its kernel happened at that cost.  Nothing launches and the wrapper's
``launches`` count does not move.  A fake tensor stands for the card when
the program runs inside :func:`for_card`: counts are made on fake CPU
tensors, which every build of PyTorch can index and differentiate (a fake
CUDA tensor needs a build with CUDA).  A real tensor never takes this
branch: on the CPU it takes the plain version, on the card the kernel.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable, List, NamedTuple


class KernelCost(NamedTuple):
    flops: float
    bytes: float
    compute_class: str  # "bf16", "tf32" or "fp32"


_FOR_CARD: ContextVar[bool] = ContextVar("kernels_for_card", default=False)
# the counters that take kernel records, innermost last
_SINKS: List[Callable[[str, KernelCost], None]] = []


@contextmanager
def for_card():
    """Fake CPU tensors inside stand for the card: each wrapper counts its
    kernel, not its plain version."""
    tok = _FOR_CARD.set(True)
    try:
        yield
    finally:
        _FOR_CARD.reset(tok)


def stands_for_card(t: Any) -> bool:
    """Is ``t`` a fake tensor of a program counted for the card?"""
    from torch._subclasses.fake_tensor import FakeTensor

    return _FOR_CARD.get() and isinstance(t, FakeTensor)


@contextmanager
def sink(fn: Callable[[str, KernelCost], None]):
    """Send every :func:`record` inside to ``fn(name, cost)``."""
    _SINKS.append(fn)
    try:
        yield
    finally:
        _SINKS.remove(fn)


def record(name: str, cost: KernelCost, out: Any) -> Any:
    """A fake launch of kernel ``name``: the innermost sink hears of it;
    returns ``out``."""
    if _SINKS:
        _SINKS[-1](name, cost)
    return out
