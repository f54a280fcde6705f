"""Weight transfer from the JAX reference: `params_from_jax` takes the
reference's stripped `{"towers", "server"}` parameter tree as numpy arrays
(towers stacked `[M, ...]`) and returns the port's tree;
`state_from_jax(name, state, ...)` does the same for the state of each
registered algorithm (numpy leaves, as `jax.tree.map(np.asarray, state)`
gives them):

  mtsl          TrainState(params, opt_state (), step) (plain SGD)
  fedavg, fedprox  {"towers": [M..], "servers": [M..]}
  splitfed      {"towers": [M..], "server"}
  smofi         {"towers": [M..], "server", "smom"} (smom as the server)
  parallelsfl   {"towers": [M..], "servers": [C..], "cidx": [M] int64}
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
    client, cluster or component axis of a stacked tree) becomes a list
    with one unit dict per repeat (each stack's kinds from
    `models.registry.stack_kinds`);
  * the result is the training tree (`models/layers.py`): every leaf in
    `cfg.param_dtype`, as the reference holds it, and the Mamba leaves
    `A_log`, `D` and `dt_bias` and the MoE `router` in f32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.registry import stack_kinds
from repro_torch.models.stacks import stack_segments
from repro_torch.utils.tree import tree_map

PyTree = Any
_ALWAYS_F32 = ("A_log", "D", "dt_bias", "router")


def convert_tree(tree, device, cfg: ModelConfig, key=None):
    """A nested dict of numpy arrays as tensors of the training tree (see
    the module docstring); no segment handling."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, device, cfg, k) for k, v in tree.items()}
    dt = torch.float32 if key in _ALWAYS_F32 else L.param_dtype(cfg)
    return torch.tensor(np.array(tree, dtype=np.float32), dtype=dt, device=device)


def _blocks(blocks, kinds, axis: int, device, cfg: ModelConfig):
    out = {}
    if "shared_attn" in kinds:
        out["shared"] = convert_tree(blocks["shared"], device, cfg)
    for si, (_, rep) in enumerate(stack_segments(cfg, kinds)):
        seg = blocks[f"seg{si}"]
        if rep == 1:
            out[f"seg{si}"] = convert_tree(seg, device, cfg)
            continue
        out[f"seg{si}"] = [
            convert_tree(tree_map(lambda a, r=r: np.take(np.asarray(a), r, axis=axis), seg),
                         device, cfg)
            for r in range(rep)
        ]
    if sorted(out) != sorted(blocks):
        raise ValueError(f"blocks {sorted(blocks)} do not match the port's "
                         f"layout {sorted(out)} for {cfg.name}")
    return out


def _side(tree, side: str, axis: int, device, cfg: ModelConfig):
    """A tower (`side` "tower") or server tree; `axis` is the segments'
    layer axis (1 under a leading client, cluster or component axis, 0 for
    one unstacked tree). Stacks become the port's segment layout, every
    other subtree is converted as it is."""
    if cfg.family in ("mlp", "resnet"):
        return convert_tree(tree, device, cfg)
    stacks = {key: kinds for (s, key), kinds in stack_kinds(cfg).items() if s == side}
    return {k: (_blocks(v, stacks[k], axis, device, cfg) if k in stacks
                else convert_tree(v, device, cfg)) for k, v in tree.items()}


def _tower(tree, axis: int, device, cfg: ModelConfig):
    return _side(tree, "tower", axis, device, cfg)


def _server(tree, axis: int, device, cfg: ModelConfig):
    return _side(tree, "server", axis, device, cfg)


def params_from_jax(tree: PyTree, device, cfg: ModelConfig) -> PyTree:
    return {"towers": _tower(tree["towers"], 1, device, cfg),
            "server": _server(tree["server"], 0, device, cfg)}


def state_from_jax(name: str, state, device, cfg: ModelConfig):
    """The port's state of algorithm `name` from the reference's (see the
    module docstring)."""
    if name == "mtsl":
        from repro_torch.core.mtsl import TrainState

        if len(state.opt_state):
            raise ValueError("state_from_jax: mtsl's optimizer state carries "
                             "over only for plain SGD (an empty opt_state)")
        params = tree_map(lambda x: x.requires_grad_(),
                          params_from_jax(state.params, device, cfg))
        return TrainState(params, (), int(state.step))
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
                torch.tensor(np.asarray(pi, dtype=np.float32), device=device))
    raise ValueError(f"state_from_jax: unknown algorithm {name!r}")
