"""Carry weights between the JAX reference and the port.

The reference's parameter and state trees arrive as nested dicts and lists
of **numpy** arrays (``jax.device_get`` of its trees); no JAX is imported
here.  Structure and leaf order are kept, so every leaf keeps its
``/``-joined path (:func:`repro_torch.tree.flatten`).

:func:`from_jax` / :func:`to_jax` keep every leaf's shape.  The one layout
change is the ResNet's: its 4-D leaves are conv weights, HWIO in JAX and
OIHW here, and only :func:`resnet_state_from_jax` / :func:`resnet_to_jax`
flip them.  The LM keeps the reference's layout everywhere
(:func:`lm_params_from_jax`, and :func:`to_jax` back), and so does the
encoder-decoder: with stacked blocks or layers their attention weights are
4-D too (``wq`` (L,d,H,hd), ``wo`` (L,H,hd,d)) and must not be flipped.

:class:`Layout` holds the same leaf functions for the checkpoint files
(:mod:`repro_torch.train.checkpoint`), which are in the reference's layout:
:data:`RESNET_LAYOUT` flips every 4-D leaf (conv weights and their optimizer
moments), and :func:`checkpoint_layout` picks it by family (``None``, the
identity, for the LM and the encoder-decoder).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


class Layout(NamedTuple):
    """A family's leaf layout on disk: ``to_disk`` maps a port leaf (numpy)
    to the reference's layout, ``from_disk`` maps it back."""

    to_disk: Callable[[np.ndarray], np.ndarray]
    from_disk: Callable[[np.ndarray], np.ndarray]


RESNET_LAYOUT = Layout(_oihw_to_hwio, _hwio_to_oihw)


def checkpoint_layout(cfg: Any) -> Optional[Layout]:
    """The layout of ``cfg``'s family in a checkpoint file: the ResNet's
    convs are HWIO there, every other family keeps the port's layout."""
    return RESNET_LAYOUT if cfg.family == "resnet" else None


def from_jax(tree: Any, device: Union[str, torch.device] = "cuda",
             requires_grad: bool = False, layout: Any = None) -> Any:
    """numpy tree -> tensor tree, every leaf copied with its shape (or
    through ``layout``, a numpy -> numpy function)."""
    dev = resolve_device(device)

    def leaf(x: Any) -> torch.Tensor:
        a = np.asarray(x)
        if layout is not None:
            a = layout(a)
        t = torch.tensor(np.ascontiguousarray(a), device=dev)  # a copy: updated in place later
        return t.requires_grad_(requires_grad) if t.is_floating_point() else t

    return tree_map(leaf, tree)


def to_jax(tree: Any, layout: Any = None) -> Any:
    """tensor tree -> numpy tree, every leaf with its shape (or through
    ``layout``)."""

    def leaf(t: Any) -> np.ndarray:
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        return np.ascontiguousarray(layout(a)) if layout is not None else a

    return tree_map(leaf, tree)


def resnet_state_from_jax(params: Any, bn: Any,
                          device: Union[str, torch.device] = "cuda") -> Tuple[Any, Any]:
    """(params, bn) of ``repro.models.resnet.init_resnet`` as port tensors,
    conv weights flipped HWIO -> OIHW; params are leaves that autograd
    differentiates."""
    return (from_jax(params, device, requires_grad=True, layout=_hwio_to_oihw),
            from_jax(bn, device))


def resnet_to_jax(tree: Any) -> Any:
    """A ResNet parameter, BatchNorm or optimizer tree of the port in the
    reference's layout (OIHW -> HWIO)."""
    return to_jax(tree, layout=_oihw_to_hwio)


def lm_params_from_jax(params: Any, device: Union[str, torch.device] = "cuda",
                       requires_grad: bool = True) -> Any:
    """Parameters of ``repro.models.transformer.init_lm`` (the VLM's
    ``patch_proj`` too) or ``repro.models.encdec.init_encdec`` (with or
    without ``frontend_proj``) as port tensors, every leaf with its shape
    and path (stacked blocks and stacked encoder and decoder layers stay
    stacked)."""
    return from_jax(params, device, requires_grad=requires_grad)
