"""Carry weights between the JAX reference and the port.

The reference's parameter and BatchNorm-state trees arrive as nested dicts
and lists of **numpy** arrays (``jax.device_get`` of its trees); no JAX is
imported here.  Structure and leaf order are kept, so every leaf keeps its
``/``-joined path (:func:`repro_torch.tree.flatten`).  The one layout
change: 4-D leaves are conv weights, HWIO in JAX and OIHW here.  ``fc/w`` is
(cin, classes) in both.
"""
from __future__ import annotations

from typing import Any, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def from_jax(tree: Any, device: Union[str, torch.device] = "cuda",
             requires_grad: bool = False) -> Any:
    """numpy tree in the reference's layout -> tensor tree in the port's."""
    dev = resolve_device(device)

    def leaf(x: Any) -> torch.Tensor:
        a = np.asarray(x)
        if a.ndim == 4:  # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        t = torch.tensor(np.ascontiguousarray(a), device=dev)  # a copy: updated in place later
        return t.requires_grad_(requires_grad) if t.is_floating_point() else t

    return tree_map(leaf, tree)


def to_jax(tree: Any) -> Any:
    """tensor tree in the port's layout -> numpy tree in the reference's."""

    def leaf(t: Any) -> np.ndarray:
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a

    return tree_map(leaf, tree)


def resnet_state_from_jax(params: Any, bn: Any,
                          device: Union[str, torch.device] = "cuda") -> Tuple[Any, Any]:
    """(params, bn) of ``repro.models.resnet.init_resnet`` as port tensors;
    params are leaves that autograd differentiates."""
    return from_jax(params, device, requires_grad=True), from_jax(bn, device)
