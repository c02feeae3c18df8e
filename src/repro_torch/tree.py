"""Nested dicts and lists of tensors (param trees, optimizer state).

Leaves are visited depth-first with dict keys in sorted order, the order
of ``jax.tree.leaves``, so trees built by different code (a model's init,
a conversion from the JAX package) line up leaf by leaf.
"""
from __future__ import annotations


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` of every leaf, in :func:`tree_leaves` order; a
    path joins dict keys and list indices with ``/`` (``layers/3/moe/
    w_gate``), as the JAX package names a leaf's path."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in :func:`tree_leaves` order;
    returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves``, given in the
    order of :func:`tree_leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
