"""Maps over the port's parameter, cache and optimizer trees: nested dicts
and lists (or tuples) with tensors (or numpy arrays) at the leaves."""
from __future__ import annotations

from typing import Any, Callable, List, Optional


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, is_leaf) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any,
                is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    """The leaves in ``tree_map``'s order (dicts in insertion order)."""
    out: List[Any] = []
    tree_map(out.append, tree, is_leaf)
    return out


def tree_unflatten(template: Any, leaves: List[Any],
                   is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``template``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template, is_leaf)
