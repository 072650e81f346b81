"""Parameter trees: the port's stand-in for ``jax.tree``.

Parameters, gradients and optimizer state are nested dicts whose leaves
are tensors (the train driver checkpoints the tuple ``(params,
opt_state)``); these helpers walk them in key order, as ``jax.tree`` walks
a dict pytree (sorted keys), and lists and tuples in index order.
``tree_map`` and ``tree_unzip`` take dicts only.
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


def _children(tree):
    """(key, subtree) pairs of a dict (sorted keys) or a list/tuple (index
    order), or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order (the order of ``jax.tree.leaves``)."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for _, v in kids for x in tree_leaves(v)]


def tree_leaves_with_path(tree, pre: str = "") -> list:
    """(path, leaf) pairs in ``tree_leaves`` order; a path joins the keys
    and sequence indices with "/", as the JAX package's checkpoints name
    ``jax.tree_util.tree_leaves_with_path``'s keys."""
    kids = _children(tree)
    if kids is None:
        return [(pre[:-1], tree)]
    return [kv for k, v in kids
            for kv in tree_leaves_with_path(v, f"{pre}{k}/")]


def tree_unflatten(tree, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``tree``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


def tree_unzip(tree, n: int) -> tuple:
    """A tree of n-tuples as n trees."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tuple(tree)
