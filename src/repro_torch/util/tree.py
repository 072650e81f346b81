"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Parameters, gradients and optimizer state are nested dicts whose leaves
are tensors; these helpers walk them in key order, as ``jax.tree`` walks a
dict pytree (sorted keys).
"""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order (the order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_leaves_with_path(tree, pre: str = "") -> list:
    """(path, leaf) pairs in ``tree_leaves`` order; a path joins the keys
    with "/"."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], f"{pre}{k}/")]
    return [(pre[:-1], tree)]


def tree_unflatten(tree, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``tree``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def tree_unzip(tree, n: int) -> tuple:
    """A tree of n-tuples as n trees."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tuple(tree)
