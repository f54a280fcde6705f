"""Minimal pytree helpers over the port's parameter and cache trees: nested
dicts (string keys) and lists (one entry per repeat of an unstacked
segment), with tensors or numpy arrays at the leaves (port of
`repro.utils.tree`, the helpers the federation and billing layers use)."""
from __future__ import annotations

import math
from typing import Any, Callable, List, Mapping

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply `fn` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_align(tree: PyTree, like: PyTree) -> PyTree:
    """`tree` with its dict keys in `like`'s order (the trees hold the same
    keys): positional leaf walks of the two then pair the same leaves, as
    they must for an update that zips a tree of gradients with its
    parameters (a checkpoint stores dicts with sorted keys)."""
    if isinstance(like, dict):
        return {k: tree_align(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [tree_align(t, v) for t, v in zip(tree, like)]
    return tree


def tree_leaves(tree: PyTree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten_like(tree: PyTree, leaves) -> PyTree:
    """`tree`'s structure with `leaves` (in `tree_leaves` order) at its
    leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_size(tree: PyTree) -> int:
    """Total number of elements (parameters) in a tree."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    """Total bytes of a tree of tensors."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: PyTree,
                       _path: str = "") -> PyTree:
    """Map `fn(path, leaf)` over the leaves, with the reference's
    '/'-joined path strings (dict keys, list and tuple indices, NamedTuple
    field names), e.g. "towers/stage0/b0/conv1/w"."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _join(_path, k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, _join(_path, i))
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", None)
        vals = [tree_map_with_path(fn, v, _join(_path, fields[i] if fields else i))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if fields else tuple(vals)
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


def flatten_dict(d: Mapping, parent: str = "", sep: str = "/") -> dict:
    """A nested dict as {'a/b/c': leaf}."""
    out = {}
    for k, v in d.items():
        key = f"{parent}{sep}{k}" if parent else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_dict(v, key, sep))
        else:
            out[key] = v
    return out


def unflatten_dict(d: Mapping, sep: str = "/") -> dict:
    """Inverse of flatten_dict."""
    out: dict = {}
    for k, v in d.items():
        parts = k.split(sep)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def partition(tree: PyTree, predicate: Callable[[str, Any], bool]):
    """(true_subtree, false_subtree): leaves failing the predicate are None
    in the first and the others None in the second; `merge` recombines
    them (the client / server parameter split)."""

    def _sel(keep: bool):
        return tree_map_with_path(
            lambda p, x: x if predicate(p, x) == keep else None, tree)

    return _sel(True), _sel(False)


def merge(a: PyTree, b: PyTree) -> PyTree:
    """Merge two partitioned trees (None marks holes)."""
    return tree_map(lambda x, y: x if x is not None else y, a, b)
