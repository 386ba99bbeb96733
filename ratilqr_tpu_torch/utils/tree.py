"""Nested containers of tensors: flatten with key paths, map, rebuild.

The port's states and results are nested ``NamedTuple``s, tuples, lists
and dicts of tensors and Python scalars.  This is the little of
``jax.tree_util`` the port needs, with JAX's key-path strings
(``keystr``): ``.field`` for a ``NamedTuple`` field, ``[i]`` for a tuple
or list item, ``['key']`` (the key's ``repr``) for a dict entry, dict
entries in sorted key order.  ``None`` is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Tuple[List[str], List[Any]]:
    """``(keys, children)`` of a container node; ``None`` for a leaf."""
    if _is_namedtuple(node):
        return [f".{f}" for f in node._fields], list(node)
    if isinstance(node, (tuple, list)):
        return [f"[{i}]" for i in range(len(node))], list(node)
    if isinstance(node, dict):
        keys = sorted(node)
        return [f"[{k!r}]" for k in keys], [node[k] for k in keys]
    return None


def _rebuild(node, children: List[Any]):
    if _is_namedtuple(node):
        return type(node)(*children)
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    return dict(zip(sorted(node), children))


def flatten_with_paths(tree: Any) -> Tuple[List[str], List[Any]]:
    """The leaves of ``tree`` in JAX's order with their key-path strings."""
    paths, leaves = [], []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            paths.append(path)
            leaves.append(node)
            return
        for key, child in zip(*kids):
            walk(child, path + key)

    walk(tree, "")
    return paths, leaves


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for c in kids[1]])

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves = [flatten_with_paths(t)[1] for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*leaves, strict=True)])
