"""Process groups of the port: one process a card.

The reference runs one process over every local device: ``jax.process_index()``
and ``jax.process_count()`` say where the process stands, and one jitted step
computes over a batch sharded across the devices.  One PyTorch process cannot
hold one tensor across cards, so the port runs W processes, one a card, in
one ``torch.distributed`` process group, and this module is what stands in
for the reference's process queries and device layout:

* :func:`init_process_group` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR``/``MASTER_PORT`` under
  ``env://``) and rendezvouses there or at a ``file://`` path (the tests'),
  then resolves the rank's device (:func:`rank_device`) and returns it.  The
  backend is explicit: ``nccl`` (the default) or ``gloo``.  Under ``nccl``
  it refuses two ranks on one card on one host with a ``ValueError`` before
  NCCL sees them (NCCL's own error is "Duplicate GPU detected").
* :func:`rank`, :func:`world_size`, :func:`backend`, :func:`device`,
  :func:`barrier`, :func:`destroy_process_group`.  Without a process group
  every one of them reports one rank, so callers behave exactly as they do
  in one process.
* The collectives the data-parallel step needs: :func:`all_reduce_`,
  :func:`broadcast_`, :func:`broadcast_tree_`, :func:`all_gather_object`.
  Under ``gloo`` a CUDA tensor goes through the host explicitly (the copy
  waits for the current stream, so the tensor is complete before the call);
  under ``nccl`` a CPU tensor goes through the rank's card.

Importing this module imports no torch: the loader layer asks it for the
rank, and a process that never imported ``torch.distributed`` has no
process group.
"""
from __future__ import annotations

import os
import socket
import sys
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0

# the device init_process_group resolved for this rank (torch.distributed's
# own group state is process-wide too); None without a group
_rank_device: Any = None


def _group() -> Any:
    """``torch.distributed`` when a process group is up, else None (without
    importing torch)."""
    td = sys.modules.get("torch.distributed")
    if td is None or not td.is_available() or not td.is_initialized():
        return None
    return td


def is_initialized() -> bool:
    return _group() is not None


def rank() -> int:
    td = _group()
    return td.get_rank() if td is not None else 0


def world_size() -> int:
    td = _group()
    return td.get_world_size() if td is not None else 1


def backend() -> Optional[str]:
    td = _group()
    return str(td.get_backend()) if td is not None else None


def device() -> Any:
    """The device :func:`init_process_group` resolved for this rank, or
    None without a process group."""
    return _rank_device if _group() is not None else None


def env_world_size() -> int:
    """``WORLD_SIZE`` from the environment (torchrun's), 0 when unset."""
    return int(os.environ.get("WORLD_SIZE", "0") or 0)


def _device_name(device: Union[str, Any], local: int) -> str:
    """The card a device request names for a rank, without touching CUDA:
    ``cuda`` is ``cuda:LOCAL_RANK``, ``cuda:N`` is card N for every rank."""
    name = str(device)
    return f"cuda:{local}" if name == "cuda" else name


def rank_device(device: Union[str, Any] = "cuda", local: int = 0) -> Any:
    """The device of a rank whose ``LOCAL_RANK`` is ``local``: ``cuda`` is
    ``cuda:local`` (raises ``ValueError`` when that card is not visible),
    an explicit ``cuda:N`` puts the rank on card N (every rank on one card:
    the one-card check), ``cpu`` only when asked."""
    import torch

    from repro_torch.device import resolve_device

    if str(device) == "cuda":
        n = torch.cuda.device_count()
        if local >= n:
            raise ValueError(
                f"LOCAL_RANK {local} is not a visible card ({n} visible): run at most one "
                "process a card, or name one card for every rank (--device cuda:0)")
        return resolve_device(f"cuda:{local}")
    return resolve_device(device)


def _check_distinct_cards(store: Any, rank_: int, world: int, name: str,
                          timeout_s: float) -> None:
    """Under NCCL every rank needs a card of its own: publish this rank's
    (host, card) to the rendezvous store and raise when another rank
    claimed it."""
    if not name.startswith("cuda"):
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {name!r}: use --dist-backend "
                         "gloo on the CPU")
    store.set(f"repro_torch/card/{rank_}", f"{socket.gethostname()}/{name}")
    store.wait([f"repro_torch/card/{q}" for q in range(world)], timedelta(seconds=timeout_s))
    cards = [store.get(f"repro_torch/card/{q}").decode() for q in range(world)]
    mine = cards[rank_]
    others = [q for q, c in enumerate(cards) if c == mine and q != rank_]
    if others:
        raise ValueError(
            f"ranks {sorted([rank_] + others)} resolve to one card ({mine}) under backend "
            "'nccl', which allows one rank a card: give each rank its own card (--device cuda, "
            "one LOCAL_RANK a card) or share one card over --dist-backend gloo")


def init_process_group(backend: str = "nccl", init_method: str = "env://",
                       device: Union[str, Any] = "cuda", *,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Join the process group named by torchrun's environment at
    ``init_method`` (``env://`` or ``file://<path>``) and return this rank's
    device.  Raises ``ValueError`` for an unknown backend, a ``WORLD_SIZE``
    that is missing, a rank's card that is not visible, or (``nccl``) two
    ranks on one card; a rendezvous that does not complete raises after
    ``timeout_s``."""
    global _rank_device
    import torch
    import torch.distributed as td

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if td.is_initialized():
        raise RuntimeError("a process group is already up in this process")
    world = env_world_size()
    if world < 1 or "RANK" not in os.environ:
        raise ValueError("init_process_group needs RANK and WORLD_SIZE in the environment "
                         "(torchrun sets them)")
    rank_ = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    timeout = timedelta(seconds=timeout_s)
    store, rank_, world = next(td.rendezvous(init_method, rank=rank_, world_size=world,
                                             timeout=timeout))
    name = _device_name(device, local)
    if backend == "nccl":
        _check_distinct_cards(store, rank_, world, name, timeout_s)
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    td.init_process_group(backend, store=store, rank=rank_, world_size=world, timeout=timeout)
    _rank_device = dev
    return dev


def destroy_process_group() -> None:
    global _rank_device
    td = _group()
    if td is not None:
        td.destroy_process_group()
    _rank_device = None


def barrier() -> None:
    td = _group()
    if td is not None:
        td.barrier()


def _staging(t: Any) -> Any:
    """Where ``t`` must be for the backend's collective, if not where it
    is: gloo reduces host memory (a CUDA tensor goes through the host;
    ``.to("cpu")`` waits for the current stream, so it is complete), NCCL
    the card's (a CPU tensor goes through the rank's card)."""
    b = backend()
    if b == "gloo" and t.is_cuda:
        return "cpu"
    if b == "nccl" and not t.is_cuda:
        return _rank_device
    return None


def all_reduce_(t: Any, op: str = "sum") -> Any:
    """Reduce ``t`` in place over the group (``sum``, ``max`` or ``min``)
    and return it; the identity without a group."""
    td = _group()
    if td is None:
        return t
    rop = {"sum": td.ReduceOp.SUM, "max": td.ReduceOp.MAX, "min": td.ReduceOp.MIN}[op]
    via = _staging(t)
    if via is None:
        td.all_reduce(t, op=rop)
    else:
        buf = t.to(via)
        td.all_reduce(buf, op=rop)
        t.copy_(buf)
    return t


def broadcast_(t: Any, src: int = 0) -> Any:
    """Overwrite ``t`` with rank ``src``'s values; the identity without a
    group."""
    td = _group()
    if td is None:
        return t
    via = _staging(t)
    if via is None:
        td.broadcast(t, src=src)
    else:
        buf = t.to(via)
        td.broadcast(buf, src=src)
        t.copy_(buf)
    return t


def broadcast_tree_(tree: Any, src: int = 0) -> Any:
    """Every tensor leaf of ``tree`` overwritten in place with rank
    ``src``'s, one flat buffer a (device, dtype); non-tensor leaves are left
    as they are.  Returns ``tree``."""
    if _group() is None:
        return tree
    import torch

    from repro_torch.tree import leaves

    groups: Dict[Tuple[Any, Any], List[Any]] = {}
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            groups.setdefault((str(t.device), t.dtype), []).append(t)
    with torch.no_grad():
        for ts in groups.values():  # leaf order: the same on every rank
            flat = broadcast_(torch.cat([t.detach().reshape(-1) for t in ts]), src)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
    return tree


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (``[obj]`` without a group)."""
    td = _group()
    if td is None:
        return [obj]
    out: List[Any] = [None] * td.get_world_size()
    td.all_gather_object(out, obj)
    return out


def group_mean(tensors: Sequence[Any]) -> List[Any]:
    """The group mean of ``tensors``: flattened into one fp32 buffer,
    all-reduced once, divided by the world size and cut back into each
    tensor's shape and dtype.  New tensors; the inputs are not changed."""
    import torch

    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    all_reduce_(flat)
    flat.div_(world_size())
    return [part.view(t.shape).to(t.dtype)
            for t, part in zip(tensors, flat.split([t.numel() for t in tensors]))]


def tree_checksum(tree: Any) -> int:
    """An integer over the bits of every tensor leaf of ``tree`` (each
    element's bit pattern times a position weight, summed in int64, which
    wraps): equal trees give equal sums on any device, in any order."""
    import torch

    from repro_torch.tree import leaves

    views = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}
    total = torch.zeros((), dtype=torch.int64)
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        bits = t.detach().contiguous().reshape(-1).view(views[t.element_size()]).long()
        weight = torch.arange(bits.numel(), device=bits.device) % 8191 + 1
        total += (bits * weight).sum().cpu()
    return int(total)


def checksum_range(tree: Any) -> Tuple[int, int]:
    """(min, max) of :func:`tree_checksum` over the group's ranks, by two
    all-reduces: equal when every rank holds the same bits."""
    import torch

    c = torch.tensor([tree_checksum(tree)], dtype=torch.int64)
    return int(all_reduce_(c.clone(), "min")), int(all_reduce_(c.clone(), "max"))
