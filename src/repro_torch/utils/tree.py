"""Minimal pytree helpers over the port's parameter and cache trees: nested
dicts (string keys) and lists (one entry per repeat of an unstacked
segment), with tensors or numpy arrays at the leaves."""
from __future__ import annotations

from typing import Any, Callable, List

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply `fn` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: PyTree,
                       _path: str = "") -> PyTree:
    """Map `fn(path, leaf)` over the leaves, with the reference's
    '/'-joined path strings (dict keys and list indices), e.g.
    "towers/stage0/b0/conv1/w"."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _join(_path, k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, _join(_path, i))
                for i, v in enumerate(tree)]
    return fn(_path, tree)


def tree_leaves_with_path(tree: PyTree, _path: str = "") -> List[tuple]:
    """[(path, leaf)] in `tree_leaves` order, paths as in
    `tree_map_with_path`."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tree_leaves_with_path(v, _join(_path, k))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, _join(_path, i))]
    return [(_path, tree)]
