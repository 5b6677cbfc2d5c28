"""Nested dict / list / tuple trees of tensors (the port's stand-in for
jax pytrees, as far as the optimizer and the checkpoint store need one).

Leaves come out in jax's flatten order -- dict keys sorted, sequences in
order -- so a tree and the reference's pytree of the same structure name
the same leaf at the same index. ``is_leaf`` may stop the walk early (the
optimizer's int8 moments are ``{"q", "s"}`` dicts standing for one
parameter each).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["leaves_with_paths", "leaves", "unflatten", "tree_map"]


def leaves_with_paths(tree, is_leaf: Optional[Callable[[Any], bool]] = None,
                      path: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in jax's order; paths written as jax's ``keystr``
    writes them (``['groups'][0]['p0']['mlp']['w_down']``)."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], is_leaf, f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, is_leaf, f"{path}[{i}]")
        return out
    return [(path, tree)]


def leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf)]


def unflatten(template, new_leaves, is_leaf=None):
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, tree, is_leaf=None):
    """``fn`` over the leaves of ``tree``."""
    return unflatten(tree, [fn(x) for x in leaves(tree, is_leaf)], is_leaf)
