"""Nested parameter and state trees of the port: dicts, lists and
NamedTuples of tensors (the reference's pytrees), walked in one order.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(tree) -> list[tuple[str, Any]] | None:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if hasattr(tree, "_fields"):                      # NamedTuple
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree, values: list):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``, which share its structure), keeping the structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    return _rebuild(tree, [
        tree_map(fn, v, *(r[k] if isinstance(r, dict) else r[i]
                          for r in rest))
        for i, (k, v) in enumerate(kids)])


def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in walk order, paths joined with '/'."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += tree_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(tree, leaves) -> Any:
    """``tree``'s structure with ``leaves`` (in walk order) as leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
