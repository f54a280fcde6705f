"""The port's dry-run specs (`repro_torch.launch.specs`) against the
reference's (`repro.launch.specs`), leaf for leaf in path, shape, dtype
and logical axes, for every assigned architecture's smoke config and
every input shape, on a stub mesh of data=4, model=2 (an object whose
`.shape` maps axis names to sizes serves the reference's `clients_for`):
the inputs, the MTSL parameters, AdamW's state and the decode programs'
caches (the tower caches stacked over clients, as the reference's are).
"""
import functools

import jax
import pytest

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.launch.dryrun import ASSIGNED as REF_ASSIGNED
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import specs
from repro_torch.launch.dryrun import ASSIGNED
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw


class StubMesh:
    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESH = {"data": 4, "model": 2}


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_flat(tree, axes) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    ax = jax.tree.structure(tree).flatten_up_to(axes)
    return {"/".join(_key(k) for k in path): (tuple(x.shape), str(x.dtype),
                                               None if a is None else tuple(a))
            for (path, x), a in zip(leaves, ax)}


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        for k, v in zip(names, tree):
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def _port_flat(tree, axes) -> dict:
    ax = dict(_walk_axes(axes))
    out = {}
    for path, x in _walk(tree):
        assert x.is_meta, path
        out[path] = (tuple(x.shape), str(x.dtype).replace("torch.", ""), ax[path])
    return out


def _walk_axes(tree, path=""):
    """Like _walk, but a tuple of names (or None) is a leaf."""
    if tree is None or (isinstance(tree, tuple) and not hasattr(tree, "_fields")
                        and all(a is None or isinstance(a, str) for a in tree)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_axes(v, f"{path}/{k}" if path else str(k))
    else:
        names = getattr(tree, "_fields", None) or range(len(tree))
        for k, v in zip(names, tree):
            yield from _walk_axes(v, f"{path}/{k}" if path else str(k))


@functools.lru_cache(maxsize=None)
def _models(arch):
    return (ref_build_model(ref_get_config(arch, smoke=True)),
            build_model(get_config(arch, smoke=True)))


@functools.lru_cache(maxsize=None)
def _params(arch, M):
    ref_model, model = _models(arch)
    ref = ref_specs.abstract_mtsl_params(ref_model, M)
    port = specs.abstract_mtsl_params(model, M)
    return ref, port


def test_assigned_and_long_context_lists_are_the_references():
    assert ASSIGNED == REF_ASSIGNED
    assert specs.LONG_CONTEXT_OK == ref_specs.LONG_CONTEXT_OK
    assert list(INPUT_SHAPES) == list(REF_SHAPES)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_equal_the_references(arch, shape):
    ref_shape, port_shape = REF_SHAPES[shape], INPUT_SHAPES[shape]
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    M, b = specs.clients_for(port_shape, MESH)
    assert (M, b) == ref_specs.clients_for(ref_shape, StubMesh(**MESH))
    assert specs.long_context_supported(cfg) == ref_specs.long_context_supported(ref_cfg)

    assert (_port_flat(*specs.input_specs(cfg, port_shape, MESH))
            == _ref_flat(*ref_specs.input_specs(ref_cfg, ref_shape, StubMesh(**MESH))))

    (ref_p, ref_a), (p, a) = _params(arch, M)
    assert _port_flat(p, a) == _ref_flat(ref_p, ref_a)
    if port_shape.kind == "train":
        ref_opt = ref_specs.abstract_opt_state(ref_adamw(1e-4), ref_p, ref_a)
        assert (_port_flat(*specs.abstract_opt_state(adamw(1e-4), p, a))
                == _ref_flat(*ref_opt))
    if port_shape.kind == "decode":
        ref_model, model = _models(arch)
        got = _port_flat(*specs.abstract_caches(model, port_shape, MESH))
        want = _ref_flat(*ref_specs.abstract_caches(ref_model, ref_shape,
                                                    StubMesh(**MESH)))
        assert got == want
        caches, _ = specs.abstract_caches(model, port_shape, MESH)
        split = specs.tower_caches(caches, M)
        assert len(split.tower) == M
        for tower in split.tower:
            for (_, x), (_, y) in zip(_walk(tower), _walk(caches.tower)):
                assert x.shape == y.shape[1:] and x.dtype == y.dtype
