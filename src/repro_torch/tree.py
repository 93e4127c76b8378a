"""Nested dicts, tuples and lists of tensors as trees, in JAX's leaf order.

The port keeps parameters, optimizer moments, caches and checkpoints as
plain nested containers, so that they cross to and from the JAX package
leaf for leaf.  Leaves come in the order ``jax.tree_util`` gives them: dict keys
sorted, sequence entries by index; ``None`` is an empty subtree.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def leaf_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf)]: a path holds dict keys, sequence indices and, for a
    NamedTuple, ``.field`` (as ``str`` of JAX's ``GetAttrKey``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in leaf_paths(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in leaf_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, which share its structure; returns the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_clone(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor cloned (other leaves shared)."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
