"""Trees between the port and the reference's layout, both ways.

`params_from_jax` takes the reference's stripped `{"towers", "server"}`
parameter tree (numpy arrays, towers stacked `[M, ...]`) and returns the
port's tree; `state_from_jax(name, state, ...)` does the same for the
state of each registered algorithm. Both take the trees as
`jax.tree.map(np.asarray, state)` gives them or as the port's
`train.checkpoint.load_checkpoint` reads a file (numpy leaves; bfloat16
leaves as CPU tensors, since numpy has no bfloat16). `params_to_reference`
and `state_to_reference` are their inverses: numpy leaves (bfloat16 ones
as CPU tensors) in the reference's layout, so that a checkpoint the port
writes is the reference's file. The states:

  mtsl          TrainState(params, opt_state, step): opt_state () (plain
                SGD) or AdamState(mu, nu) (f32 trees shaped as params);
                step an int in the port, an int32 0-d array in the
                reference's tree
  fedavg, fedprox  {"towers": [M..], "servers": [M..]}
  splitfed      {"towers": [M..], "server"}
  smofi         {"towers": [M..], "server", "smom"} (smom as the server)
  parallelsfl   {"towers": [M..], "servers": [C..], "cidx": [M]} (int64 in
                the port, int32 in the reference)
  fedem         (components [K..] of {"tower", "server"}, pi [M, K] f32)

For the paper classifiers (`family` "mlp" / "resnet") keys and layouts
are kept as they are, every leaf in f32 (their `cfg.dtype`). For the LMs
(every other family):

  * keys are kept: the stack-level `shared` block of a hybrid stack, the
    VLM tower's `projector`, the MoE leaves (`router`, the `[E, ...]`
    expert stacks, `shared` experts) and the encoder-decoder's server keys
    (`enc_blocks`, `enc_norm`, `dec_embed`, `dec_blocks`) included;
  * a `seg{i}` segment that the reference stacks along a layer axis (a
    repeating segment under `cfg.scan_layers`; the axis follows the leading
    client, cluster or component axis of a stacked tree) is a list with
    one unit dict per repeat in the port (each stack's kinds from
    `models.registry.stack_kinds`);
  * the port's tree is the training tree (`models/layers.py`): every leaf
    in `cfg.param_dtype`, as the reference holds it, the Mamba leaves
    `A_log`, `D` and `dt_bias` and the MoE `router` in f32, and an
    optimizer moment in f32.

`to_serving_tree` casts a training tree to the serving tree the engines
take (matmul weights in cfg.dtype; `models/layers.py`).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.registry import Model, stack_kinds
from repro_torch.models.stacks import stack_segments
from repro_torch.nn.init import abstract_params
from repro_torch.utils.tree import tree_map

PyTree = Any
_ALWAYS_F32 = ("A_log", "D", "dt_bias", "router")


def _f32(x) -> np.ndarray:
    """A numpy array or a (CPU, possibly bfloat16) tensor as f32 numpy (no
    copy of an f32 array: the caller's torch.tensor makes the one copy)."""
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def convert_tree(tree, device, cfg: ModelConfig, key=None,
                 dtype: Optional[torch.dtype] = None):
    """A nested dict of arrays as tensors of the training tree (see the
    module docstring), every leaf in `dtype` when it is given; no segment
    handling."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, device, cfg, k, dtype) for k, v in tree.items()}
    dt = dtype or (torch.float32 if key in _ALWAYS_F32 else L.param_dtype(cfg))
    return torch.tensor(_f32(tree), dtype=dt, device=device)


def _stacks(cfg: ModelConfig, side: str) -> dict:
    """{key: block kinds} of the layer stacks in a `side` tree (none for
    the classifiers)."""
    if cfg.family in ("mlp", "resnet"):
        return {}
    return {key: kinds for (s, key), kinds in stack_kinds(cfg).items() if s == side}


def _from_ref(tree, side: str, axis: int, leaf: Callable, cfg: ModelConfig):
    """A reference tower (`side` "tower") or server tree in the port's
    layout, `leaf(subtree)` converting each plain subtree; `axis` is the
    segments' layer axis (1 under a leading client, cluster or component
    axis, 0 for one unstacked tree)."""
    stacks = _stacks(cfg, side)
    if not stacks:
        return leaf(tree)
    out = {}
    for k, v in tree.items():
        if k not in stacks:
            out[k] = leaf(v)
            continue
        blocks = {}
        if "shared_attn" in stacks[k]:
            blocks["shared"] = leaf(v["shared"])
        for si, (_, rep) in enumerate(stack_segments(cfg, stacks[k])):
            seg = v[f"seg{si}"]
            blocks[f"seg{si}"] = leaf(seg) if rep == 1 else [
                leaf(tree_map(lambda a, r=r: _take(a, r, axis), seg))
                for r in range(rep)]
        if sorted(blocks) != sorted(v):
            raise ValueError(f"blocks {sorted(v)} do not match the port's "
                             f"layout {sorted(blocks)} for {cfg.name}")
        out[k] = blocks
    return out


def _take(a, r: int, axis: int):
    return a.select(axis, r) if torch.is_tensor(a) else np.take(np.asarray(a), r, axis=axis)


def _to_ref(tree, side: str, axis: int, cfg: ModelConfig):
    """Inverse of _from_ref: a port tower or server tree as the reference's
    (numpy leaves; bfloat16 ones as CPU tensors), each segment list
    restacked along `axis`."""
    stacks = _stacks(cfg, side)
    if not stacks:
        return tree_map(_host, tree)
    out = {}
    for k, v in tree.items():
        if k not in stacks:
            out[k] = tree_map(_host, v)
            continue
        out[k] = {}
        for sk, seg in v.items():
            if isinstance(seg, list):
                out[k][sk] = tree_map(lambda *xs: _stack(xs, axis), *seg)
            else:
                out[k][sk] = tree_map(_host, seg)
    return out


def _host(x):
    """A tensor as a numpy array of its dtype (a bfloat16 one as a CPU
    tensor: numpy has no bfloat16)."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    return x if x.dtype == torch.bfloat16 else x.numpy()


def _stack(xs, axis: int):
    return _host(torch.stack([x.detach() for x in xs], dim=axis))


def _tower(tree, axis, device, cfg, dtype=None):
    return _from_ref(tree, "tower", axis,
                     lambda t: convert_tree(t, device, cfg, dtype=dtype), cfg)


def _server(tree, axis, device, cfg, dtype=None):
    return _from_ref(tree, "server", axis,
                     lambda t: convert_tree(t, device, cfg, dtype=dtype), cfg)


def params_from_jax(tree: PyTree, device, cfg: ModelConfig,
                    dtype: Optional[torch.dtype] = None) -> PyTree:
    """The port's {"towers", "server"} tree from the reference's (every
    leaf in `dtype` when given: an optimizer moment)."""
    return {"towers": _tower(tree["towers"], 1, device, cfg, dtype),
            "server": _server(tree["server"], 0, device, cfg, dtype)}


def params_to_reference(params: PyTree, cfg: ModelConfig) -> PyTree:
    """The reference's {"towers", "server"} tree from the port's."""
    return {"towers": _to_ref(params["towers"], "tower", 1, cfg),
            "server": _to_ref(params["server"], "server", 0, cfg)}


def _is_adam(opt) -> bool:
    return tuple(getattr(opt, "_fields", ())) == ("mu", "nu")


def state_from_jax(name: str, state, device, cfg: ModelConfig):
    """The port's state of algorithm `name` from the reference's (see the
    module docstring)."""
    if name == "mtsl":
        from repro_torch.core.mtsl import TrainState
        from repro_torch.optim.optimizers import AdamState

        opt = state.opt_state
        if _is_adam(opt):
            opt = AdamState(*(params_from_jax(t, device, cfg, torch.float32)
                              for t in (opt.mu, opt.nu)))
        elif len(opt):
            raise ValueError("state_from_jax: mtsl's optimizer state carries "
                             "over for plain SGD (an empty opt_state) and "
                             "AdamW (AdamState(mu, nu)) only")
        params = tree_map(lambda x: x.requires_grad_(),
                          params_from_jax(state.params, device, cfg))
        return TrainState(params, opt, int(np.asarray(state.step)))
    if name in ("fedavg", "fedprox"):
        return {"towers": _tower(state["towers"], 1, device, cfg),
                "servers": _server(state["servers"], 1, device, cfg)}
    if name == "splitfed":
        return params_from_jax(state, device, cfg)
    if name == "smofi":
        return {**params_from_jax(state, device, cfg),
                "smom": _server(state["smom"], 0, device, cfg)}
    if name == "parallelsfl":
        return {"towers": _tower(state["towers"], 1, device, cfg),
                "servers": _server(state["servers"], 1, device, cfg),
                "cidx": torch.tensor(np.asarray(state["cidx"]), dtype=torch.int64,
                                     device=device)}
    if name == "fedem":
        comps, pi = state
        return ({"tower": _tower(comps["tower"], 1, device, cfg),
                 "server": _server(comps["server"], 1, device, cfg)},
                torch.tensor(_f32(pi), device=device))
    raise ValueError(f"state_from_jax: unknown algorithm {name!r}")


def state_to_reference(name: str, state, cfg: ModelConfig):
    """The reference's state of algorithm `name` from the port's: the
    inverse of state_from_jax (see the module docstring)."""
    if name == "mtsl":
        opt = state.opt_state
        if _is_adam(opt):
            opt = type(opt)(*(params_to_reference(t, cfg) for t in opt))
        elif len(opt):
            raise ValueError("state_to_reference: mtsl's optimizer state must "
                             "be empty (SGD) or AdamState(mu, nu)")
        return type(state)(params_to_reference(state.params, cfg), opt,
                           np.asarray(state.step, np.int32))
    if name in ("fedavg", "fedprox"):
        return {"towers": _to_ref(state["towers"], "tower", 1, cfg),
                "servers": _to_ref(state["servers"], "server", 1, cfg)}
    if name == "splitfed":
        return params_to_reference(state, cfg)
    if name == "smofi":
        return {**params_to_reference(state, cfg),
                "smom": _to_ref(state["smom"], "server", 0, cfg)}
    if name == "parallelsfl":
        return {"towers": _to_ref(state["towers"], "tower", 1, cfg),
                "servers": _to_ref(state["servers"], "server", 1, cfg),
                "cidx": _host(state["cidx"]).astype(np.int32)}
    if name == "fedem":
        comps, pi = state
        return ({"tower": _to_ref(comps["tower"], "tower", 1, cfg),
                 "server": _to_ref(comps["server"], "server", 1, cfg)},
                _host(pi))
    raise ValueError(f"state_to_reference: unknown algorithm {name!r}")


def to_serving_tree(model: Model, params: PyTree) -> PyTree:
    """A {"towers", "server"} training tree (f32 masters) as the serving
    tree the engines take: each leaf detached and cast to the dtype of the
    same leaf of `model`'s serving init (matmul weights to cfg.dtype).
    Raises where a leaf's shape is not the config's (a checkpoint of
    another config)."""
    gen = torch.Generator()
    with abstract_params():
        tower = model.init_tower(gen, serving=True)
        server = model.init_server(gen, serving=True)

    def cast(x, t, lead: int):
        if tuple(x.shape[lead:]) != tuple(t.shape):
            raise ValueError(f"a leaf of shape {tuple(x.shape)} where "
                             f"{model.cfg.name}'s config has {tuple(t.shape)}")
        return x.detach().to(t.dtype)

    with torch.no_grad():
        return {"towers": tree_map(lambda x, t: cast(x, t, 1), params["towers"], tower),
                "server": tree_map(lambda x, t: cast(x, t, 0), params["server"], server)}
