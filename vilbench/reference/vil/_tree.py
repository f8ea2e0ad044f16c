"""Minimal pytree helpers for NamedTuple states of tensors.

The port keeps the JAX package's state types as NamedTuples; these walk
NamedTuples, tuples, lists and dicts, and treat everything else as a leaf.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``."""
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, (tuple, list)):
        return [l for x in tree for l in tree_leaves(x)]
    if isinstance(tree, dict):
        return [l for k in tree for l in tree_leaves(tree[k])]
    return [tree]
