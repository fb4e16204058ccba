"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

A tree is a tensor (a leaf) or a dict of trees; leaves are visited in
insertion order, which the trees built by the port keep stable.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    """The tree's leaves, depth first in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """A tree of ``fn(leaf, *matching leaves of rest)`` with ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its own."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, _prefix: str = "") -> Any:
    """A tree of ``fn(path, leaf, *matching leaves of rest)``, ``path`` the
    leaf's keys joined by ``/`` (``"layers/attn/wq"``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), _prefix=f"{_prefix}{k}/")
                for k, v in tree.items()}
    return fn(_prefix[:-1], tree, *rest)
