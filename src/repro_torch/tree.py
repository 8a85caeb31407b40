"""Parameter trees: nested dicts and lists with tensor (or array) leaves.

Leaves are visited in the order ``jax.tree.leaves`` visits the reference's
trees (dict keys sorted, lists in order), and named by the same ``/``-joined
paths as ``repro/train/checkpoint.py``'s ``_flatten`` (``stem/conv/w``,
``stage1/0/proj/w``), so both packages agree on every leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` in leaf order."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def leaves(tree: Any) -> List[Any]:
    return list(flatten(tree).values())


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)

