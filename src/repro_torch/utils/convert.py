"""Weight transfer from the JAX reference: `params_from_jax` takes the
reference's stripped `{"towers", "server"}` parameter tree as numpy arrays
(towers stacked `[M, ...]`) and returns the port's tree.

For the paper classifiers (`family` "mlp" / "resnet") keys and layouts
are kept as they are, every leaf in f32 (their `cfg.dtype`). For the
decoder models (`family` "dense" / "ssm" / "hybrid"):

  * keys are kept, the stack-level `shared` block of a hybrid stack
    included;
  * a `seg{i}` segment that the reference stacks along a layer axis (a
    repeating segment under `cfg.scan_layers`; the axis follows the client
    axis in the towers) becomes a list with one unit dict per repeat;
  * the result is the training tree (`models/layers.py`): every leaf in
    `cfg.param_dtype`, as the reference holds it, and the Mamba leaves
    `A_log`, `D` and `dt_bias` in f32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.stacks import stack_segments
from repro_torch.utils.tree import tree_map

PyTree = Any
_ALWAYS_F32 = ("A_log", "D", "dt_bias")


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


def params_from_jax(tree: PyTree, device, cfg: ModelConfig) -> PyTree:
    if cfg.family in ("mlp", "resnet"):
        return {"towers": convert_tree(tree["towers"], device, cfg),
                "server": convert_tree(tree["server"], device, cfg)}
    kinds = cfg.layer_kinds
    split = cfg.split_layers
    towers, server = tree["towers"], tree["server"]
    return {
        "towers": {
            "embed": convert_tree(towers["embed"], device, cfg),
            "blocks": _blocks(towers["blocks"], kinds[:split], 1, device, cfg),
        },
        "server": {
            "blocks": _blocks(server["blocks"], kinds[split:], 0, device, cfg),
            "norm": convert_tree(server["norm"], device, cfg),
            "head": convert_tree(server["head"], device, cfg),
        },
    }
