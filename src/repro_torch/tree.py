"""Nested dicts, tuples and lists of tensors (the port's parameters and
optimizer state) walked in ``jax.tree``'s leaf order: a dict's keys sorted,
a tuple's or a list's items in order.

The reference flattens its pytrees in that order, and it is part of the
results: the optimizer's global-norm clip sums its leaves in it (another
order moves the sum, and so every clipped gradient, by an ulp), and a
checkpoint stores its leaves as ``leaf_0, leaf_1, ...`` in it.
"""

from __future__ import annotations

from typing import Callable, Optional


_END = object()


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves``' order; ``is_leaf(node)``
    true stops the walk at ``node``."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid, is_leaf)]


def tree_unflatten(like, leaves, is_leaf: Optional[Callable] = None):
    """A tree shaped as ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node) or _children(node) is None:
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}     # keep the like tree's key order
        return type(node)(build(kid) for kid in node)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` of each leaf of ``tree`` and the leaves at the same place in
    each of ``rest`` (trees of the same structure)."""
    flat = [tree_leaves(t, is_leaf) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)], is_leaf)
