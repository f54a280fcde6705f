"""Checkpoints in the reference's file format (port of
`repro.train.checkpoint`), so that each package reads the other's files.

A file is one MessagePack object (`utils/msgpack_codec.py`; the card's
machine has no `msgpack` package). Arrays are stored as
{"__nd__": True, "dtype", "shape", "data"} with numpy's dtype names
("float32", "int32", "bfloat16", ...) and the raw C-order bytes; dicts
with their keys sorted, as `jax.device_get` leaves the reference's trees;
lists and tuples as {"__list__", "__tuple__"}; a NamedTuple as
{"__namedtuple__": "module:QualName", "__list__"} with the reference's
module path (`repro_torch.` written as `repro.`, e.g.
`repro.core.mtsl:TrainState`). On read, a `repro.` path resolves to the
port's module of the same name (never importing `repro`), and a path with
no counterpart gives a plain tuple, as the reference degrades it. Writes go
to `path + ".tmp"` and are renamed into place.

`load_checkpoint` returns numpy arrays at the leaves (a bfloat16 array as
a CPU tensor: numpy has no bfloat16). `save_algorithm_state` /
`load_algorithm_state` store an Algorithm's state in the reference's tree
layout (`utils.convert.state_to_reference`; the model config says how the
port's layer segments stack) and convert it back on load
(`state_from_jax`) onto the requested device.
"""
from __future__ import annotations

import importlib
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import msgpack_codec
from repro_torch.utils.convert import state_from_jax, state_to_reference

PyTree = Any

_KIND = "__nd__"
_NT = "__namedtuple__"
_REF, _PORT = "repro", "repro_torch"


def _swap_root(module: str, old: str, new: str) -> str:
    if module == old or module.startswith(old + "."):
        return new + module[len(old):]
    return module


def _array(obj) -> dict:
    if torch.is_tensor(obj):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, data = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            name, data = str(a.dtype), a.tobytes()
    else:
        a = np.asarray(obj)
        name, data = str(a.dtype), a.tobytes()
    return {_KIND: True, "dtype": name, "shape": list(obj.shape), "data": data}


def _pack(obj):
    if torch.is_tensor(obj) or isinstance(obj, (np.ndarray, np.generic)):
        return _array(obj)
    if isinstance(obj, dict):
        return {str(k): _pack(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        module = _swap_root(type(obj).__module__, _PORT, _REF)
        return {_NT: f"{module}:{type(obj).__qualname__}",
                "__list__": [_pack(v) for v in obj]}
    if isinstance(obj, (list, tuple)):
        return {"__list__": [_pack(v) for v in obj],
                "__tuple__": isinstance(obj, tuple)}
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    raise TypeError(f"cannot checkpoint {type(obj)}")


def _resolve_namedtuple(spec: str):
    mod, _, qual = spec.partition(":")
    try:
        cls = importlib.import_module(_swap_root(mod, _REF, _PORT))
        for part in qual.split("."):
            cls = getattr(cls, part)
        return cls
    except (ImportError, AttributeError):
        return None  # no counterpart: degrade to a plain tuple


def _unarray(obj):
    shape = tuple(obj["shape"])
    if obj["dtype"] == "bfloat16":
        if not obj["data"]:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(obj["data"]),
                                dtype=torch.bfloat16).reshape(shape)
    # a read-only view of the file's bytes (the reference's arrays are
    # immutable too); converting it to a tensor makes the one copy
    return np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"])).reshape(shape)


def _unpack(obj):
    if isinstance(obj, dict):
        if obj.get(_KIND):
            return _unarray(obj)
        if _NT in obj:
            seq = [_unpack(v) for v in obj["__list__"]]
            cls = _resolve_namedtuple(obj[_NT])
            return cls(*seq) if cls is not None else tuple(seq)
        if "__list__" in obj:
            seq = [_unpack(v) for v in obj["__list__"]]
            return tuple(seq) if obj.get("__tuple__") else seq
        return {k: _unpack(v) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, tree: PyTree) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        msgpack_codec.dump(_pack(tree), f)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> PyTree:
    with open(path, "rb") as f:
        return _unpack(msgpack_codec.unpackb(f.read()))


# ---------------------------------------------------------------------------
# Algorithm-state checkpoints (uniform across the Algorithm registry)
# ---------------------------------------------------------------------------


def save_algorithm_state(path: str, algorithm, state: PyTree,
                         extra: Optional[dict] = None, *,
                         cfg: ModelConfig) -> None:
    """Checkpoint a registered algorithm's state (in the reference's tree
    layout for `cfg`). `algorithm` is an Algorithm or a registry name; the
    file records the name so `load_algorithm_state` can refuse a
    mismatch."""
    from repro_torch.core.algorithms import get_algorithm

    alg = get_algorithm(algorithm) if isinstance(algorithm, str) else algorithm
    tree = {"algorithm": alg.name,
            "state": alg.state_to_tree(state_to_reference(alg.name, state, cfg))}
    if extra:
        tree["extra"] = extra
    save_checkpoint(path, tree)


def load_algorithm_state(path: str, algorithm=None, *, cfg: ModelConfig,
                         device="cpu"):
    """Returns (state, algorithm name, extra dict), the state in the port's
    layout for `cfg` on `device`. If `algorithm` (an Algorithm or a name)
    is given, it is checked against the name recorded in the file;
    otherwise the recorded name is looked up in the registry."""
    from repro_torch.core.algorithms import get_algorithm

    tree = load_checkpoint(path)
    name = tree.get("algorithm")
    if algorithm is not None:
        alg = get_algorithm(algorithm) if isinstance(algorithm, str) else algorithm
        if name is not None and alg.name != name:
            raise ValueError(
                f"checkpoint {path!r} was written by algorithm {name!r}, "
                f"not {alg.name!r}")
    else:
        alg = get_algorithm(name)
    state = state_from_jax(alg.name, alg.state_from_tree(tree["state"]), device, cfg)
    return state, alg.name, tree.get("extra", {})
