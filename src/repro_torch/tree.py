"""Parameter trees: nested dicts of tensors, as the models lay them out.

`leaves` walks the dict keys sorted, the order ``jax.tree_util``
flattens a dict in, so that a float sum across leaves (the optimizer's
global norm) adds them in the reference's order.
"""
from __future__ import annotations


def leaves(tree):
    """The leaves of ``tree``, dict keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same keys), as a tree of ``tree``'s layout."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unzip(tree, n):
    """A tree whose leaves are ``n``-tuples as ``n`` trees."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tuple(tree)
