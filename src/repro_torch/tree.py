"""Nested dict/list trees: the port's stand-in for jax pytrees.

Containers are dicts, walked in sorted key order as jax flattens them, and
lists.  Every other value, ``None`` and ``SparseTensor`` included, is a
leaf.  Key paths print in jax's ``keystr`` form
(``['stages'][0]['0']['attn']['wq']['kernel']``), so a bank manifest's path
strings name the same leaves in both packages.
"""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def flatten_with_path(tree: PyTree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] in jax's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(template: PyTree, leaves: list) -> PyTree:
    """``leaves``, in jax's flatten order, back in ``template``'s
    structure."""
    paths = [p for p, _ in flatten_with_path(template)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(paths)}")
    by_path = dict(zip(paths, leaves))
    return map_with_path(lambda p, _: by_path[p], template)


def map_with_path(fn: Callable, tree: PyTree, prefix: str = "") -> PyTree:
    """``fn(keystr path, leaf)`` over every leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}[{i}]")
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             _path: str = "") -> PyTree:
    """Apply ``fn`` leafwise over trees of one structure.

    A structural mismatch raises with the first offending key path instead
    of pairing leaves of different trees.
    """
    where = _path or "<root>"
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"tree structure differs at {where}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            _path=f"{_path}[{k!r}]") for k in tree}
    if isinstance(tree, list):
        for r in rest:
            if not isinstance(r, list) or len(r) != len(tree):
                raise ValueError(f"tree structure differs at {where}")
        return [tree_map(fn, v, *(r[i] for r in rest), _path=f"{_path}[{i}]")
                for i, v in enumerate(tree)]
    for r in rest:
        if isinstance(r, (dict, list)):
            raise ValueError(f"tree structure differs at {where}")
    return fn(tree, *rest)


def device_of(tree: PyTree):
    """The device of the first tensor-like leaf (anything with
    ``.device``)."""
    return next(x.device for x in leaves(tree) if hasattr(x, "device"))


def to_device(tree: PyTree, device) -> PyTree:
    """Move every tensor-like leaf (anything with ``.to``) to ``device``."""
    return tree_map(lambda x: x.to(device) if hasattr(x, "to") else x, tree)
