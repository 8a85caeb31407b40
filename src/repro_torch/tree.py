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


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over ``tree``, each leaf named by its
    :func:`flatten` path; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def unbind(tree: Any) -> List[Any]:
    """A tree of tensors stacked on a leading axis -> one tree per index
    (views; one unbind per leaf)."""
    if isinstance(tree, dict):
        per_key = {k: unbind(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: per_key[k][i] for k in per_key} for i in range(n)]
    return list(tree.unbind(0))


def stack_init(n: int, make: Callable[[], Any]) -> Any:
    """``n`` trees from ``make()``, stacked on a new leading axis: each leaf
    is allocated once and filled index by index, in call order, so one
    tree is live beside the stack (stacking a list would hold it twice)."""
    first = make()
    stacked = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    tree_map(lambda dst, src: dst[0].copy_(src), stacked, first)
    del first
    for i in range(1, n):
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, make())
    return stacked
