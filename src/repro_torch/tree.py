"""``tree_map`` over the port's parameter and cache trees: nested dicts and
lists with tensors (or numpy arrays) at the leaves."""
from __future__ import annotations

from typing import Any, Callable, Optional


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, is_leaf) for v in tree]
    return fn(tree)
