"""Per-residual-block data as a small tree: None, an array (or a number),
or a tuple, list or dict of such trees. The JAX package takes any jax
pytree here; these are the containers its users pass."""
from __future__ import annotations


def tree_map(fn, tree):
    """fn applied to every leaf, the containers kept."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_stack(trees, stack):
    """The trees (all of one structure) stacked leaf by leaf with
    `stack(list of leaves)`."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(tree_stack([t[i] for t in trees], stack)
                            for i in range(len(first)))
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees], stack) for k in first}
    return stack(list(trees))
