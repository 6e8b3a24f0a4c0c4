"""Nested param trees and recurrent carries (the port's counterpart of the
``jax.tree_util`` calls the reference makes).

A tree is a dict (keys in insertion order), a tuple or a list of trees, a
leaf (a tensor, or a numpy array on the interop side), or None (an empty
subtree). Params are dicts of leaves, nested where a wrapper holds its
layer's params (Bidirectional's ``{"fwd": {...}, "bwd": {...}}``);
optimizer states are ``{slot: tree like the params}``; a recurrent carry
is one tensor (GRU, SimpleRnn) or a tuple of them (LSTM's ``(h, c)``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _is_node(t) -> bool:
    return isinstance(t, (dict, tuple, list))


def tree_items(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, depth first in the tree's own order; a
    path is the keys and indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in tree_items(v, prefix + (k,))]
    if _is_node(tree):
        return [item for i, v in enumerate(tree)
                for item in tree_items(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    """Every leaf of ``tree``, in :func:`tree_items`' order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``tree`` with each leaf replaced by ``fn(leaf, *leaves of rest at
    the same place)``; ``rest`` share ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_get(tree, path: Path):
    """The subtree or leaf of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: dict, path: Path, value) -> None:
    """Put ``value`` at ``path`` in a tree of nested dicts, in place,
    making the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tree_copy_(dst, src) -> None:
    """Copy each leaf of ``src`` into the leaf of ``dst`` at the same
    place, in place, skipping leaves that already share their memory."""
    for (_, d), (_, s) in zip(tree_items(dst), tree_items(src)):
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)
