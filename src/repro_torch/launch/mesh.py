"""Device meshes of the port.

A :class:`Mesh` is a numpy array of devices with a name for each axis: what
``jax.sharding.Mesh`` is to the reference (``repro/launch/mesh.py``), and
what sharded delivery (:mod:`repro_torch.core.delivery`) and the partition
rules (:mod:`repro_torch.models.sharding`) read: ``devices``,
``axis_names`` and ``shape`` (axis name -> size).  Functions, not module
constants, as in the reference, so importing this module touches no CUDA
state.

In one process, :func:`make_mesh` defaults to the visible CUDA devices and
raises when their count is not the mesh's size, as ``jax.make_mesh`` does.
A caller may name the devices, and may name one device more than once
(``devices=["cpu"] * 4``): the stand-in for the reference tests' four host
devices.  Lanes that share one device compose into one tensor there; lanes
on distinct devices of one process are refused by sharded delivery (one
process cannot build one tensor across cards).

Under a process group (:mod:`repro_torch.launch.dist`, one process a card)
the mesh is over the group's ranks instead, as the reference's is over
every process's devices: the element of rank r is a
:class:`RankDevice` carrying ``process_index = r``, and this rank's own
element is its ``torch.device``, so
:meth:`~repro_torch.core.delivery.LanePlan.build` finds each rank's lanes
and each rank composes its own rows on its own card.  The reference's TPU
speed and memory constants are not carried over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import dist


@dataclass(frozen=True)
class RankDevice:
    """Another rank's element of a process mesh: its rank, as a reference
    device carries its process; the device itself lives in that rank's
    process."""

    process_index: int


class Mesh:
    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of rank {self.devices.ndim} needs as many axis names, "
                             f"got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: the process group's
    ranks when one is up, else every visible CUDA device, raising when there
    is no card); raises ``ValueError`` when the device count is not
    ``prod(shape)``."""
    if devices is None and dist.is_initialized():
        me, mine = dist.rank(), dist.device()
        if mine is None:
            raise ValueError("the process group was not started by "
                             "repro_torch.launch.dist.init_process_group: no rank device")
        devs = [mine if r == me else RankDevice(r) for r in range(dist.world_size())]
    elif devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    n = math.prod(shape)
    if len(devs) != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} devices, got {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, (16, 16) over ("data", "model")
    or (2, 16, 16) with "pod" in front: raises on fewer cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
