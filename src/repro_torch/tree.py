"""Nested dicts, lists and tuples of tensors: the port's pytrees.

`tree_map` walks the first tree and takes the matching parts of the
others (so a tree of shape tuples rides along as leaves), `tree_leaves`
yields the leaves in the same order, and `tree_unflatten` puts leaves
back in that order. Dicts are walked in insertion order; where JAX's leaf
order matters (a checkpoint), the caller sorts.
"""
from __future__ import annotations

from typing import Iterator


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_unflatten(like, leaves):
    """A tree shaped as `like` holding `leaves` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
