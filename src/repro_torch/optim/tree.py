"""Nested-dict trees of tensors, walked as ``jax.tree_util`` walks the
reference's: dict keys in sorted order, so a sum over leaves adds in the
reference's order."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_leaves`` order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(``/``-joined dict path, leaf) pairs in the same order: the keys of
    the reference's checkpoint files (``params/layers/wq``)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in leaves_with_path(
            tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping ``tree``'s structure."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or set(r) != set(tree) for r in rest):
            raise ValueError("trees of different structure")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def unzip(tree, n: int):
    """A tree of ``n``-tuples as ``n`` trees."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in sorted(tree)} for i in range(n))
    return tuple(tree)
