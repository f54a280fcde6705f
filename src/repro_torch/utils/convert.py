"""Weight transfer from the JAX reference: `params_from_jax` takes the
reference's stripped `{"towers", "server"}` parameter tree as numpy arrays
(towers stacked `[M, ...]`) and returns the port's tree.

For the paper classifiers (`family` "mlp" / "resnet") keys and layouts
are kept as they are, every leaf in f32 (their `cfg.dtype`). For the
decoder models:

  * keys are kept;
  * a `seg{i}` segment that the reference stacks along a layer axis (a
    repeating segment under `cfg.scan_layers`; the axis follows the client
    axis in the towers) becomes a list with one unit dict per repeat;
  * each leaf is cast to the dtype the reference uses it in: matmul
    weights and the head in `cfg.dtype`, embedding tables and norm scales
    in `cfg.param_dtype` (f32).
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
_KEPT_IN_PARAM_DTYPE = ("table", "scale")


def convert_tree(tree, device, cfg: ModelConfig, key=None):
    """A nested dict of numpy arrays as tensors, each leaf in the dtype the
    reference uses it in (see the module docstring); no segment handling."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, device, cfg, k) for k, v in tree.items()}
    dt = L.param_dtype(cfg) if key in _KEPT_IN_PARAM_DTYPE else L.compute_dtype(cfg)
    return torch.tensor(np.array(tree, dtype=np.float32), dtype=dt, device=device)


def _blocks(blocks, kinds, axis: int, device, cfg: ModelConfig):
    out = {}
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
    if len(out) != len(blocks):
        raise ValueError(f"segments {sorted(blocks)} do not match the port's "
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
