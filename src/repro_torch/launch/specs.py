"""Dry-run specs (port of `repro.launch.specs`): meta-device stand-ins for
every program input (shapes and dtypes, no storage) and the logical axes
of every leaf, leaf for leaf as the reference annotates them.

Programs per input shape (the reference's DESIGN.md §6):
    train_4k     -> train_step(state, batch, component_lr)
    prefill_32k  -> prefill_step(params, inputs)
    decode_32k / long_500k -> decode_step(params, caches, token, pos)

The reference tags each parameter with its logical axes where it creates
it; the port's parameters carry none, so `param_axes` gives them from
the leaf's name and its parent's (`_PARAM_AXES`, the reference's tags by
that pair) after the leading client and layer dims. A mesh is its axis
sizes: a mapping {"data": 16, "model": 16}, a DeviceMesh, or any object
whose `.shape` maps axis names to sizes.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.split import stack_towers
from repro_torch.launch.mesh import num_clients_for
from repro_torch.models.registry import Model
from repro_torch.nn.init import abstract_params
from repro_torch.serve.engine import ServeCaches
from repro_torch.utils.tree import tree_map, tree_map_with_path

PyTree = Any

# archs that can serve a 524288-token context (the reference's DESIGN.md §6)
LONG_CONTEXT_OK = {
    "gemma3-12b",  # 5:1 sliding-window:global
    "mamba2-130m",  # SSM, O(1) state
    "zamba2-7b",  # hybrid
    "mistral-nemo-12b-swa",  # beyond-paper SWA variant
}


def long_context_supported(cfg: ModelConfig) -> bool:
    return cfg.name in LONG_CONTEXT_OK


def clients_for(shape: ShapeConfig, mesh) -> tuple[int, int]:
    """(num_clients M, per-client batch b) for a shape on a mesh."""
    M = num_clients_for(mesh)
    if shape.global_batch < M:
        return shape.global_batch, 1  # e.g. long_500k: one client
    if shape.global_batch % M:
        raise ValueError(f"global batch {shape.global_batch} of {shape.name} does "
                         f"not split over {M} clients")
    return M, shape.global_batch // M


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> tuple[dict, dict]:
    """(meta tensor dict, logical-axes dict) for the model inputs of one
    shape."""
    M, b = clients_for(shape, mesh)
    S = 1 if shape.kind == "decode" else shape.seq_len
    meta = torch.device("meta")
    specs, axes = {}, {}
    specs["tokens"] = torch.empty((M, b, S), dtype=torch.int32, device=meta)
    axes["tokens"] = ("client", None, None)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["vis"] = torch.empty((M, b, cfg.vis_seq, cfg.vis_dim),
                                   dtype=torch.float32, device=meta)
        axes["vis"] = ("client", None, None, None)
    if cfg.family == "encdec" and shape.kind != "decode":
        specs["frames"] = torch.empty((M, b, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.float32, device=meta)
        axes["frames"] = ("client", None, None, None)
    return specs, axes


# ---------------------------------------------------------------------------
# parameters / optimizer state (abstract)
# ---------------------------------------------------------------------------

_QKV = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}
_MLP = {"wg": ("embed", "ffn"), "wu": ("embed", "ffn"), "wd": ("ffn", "embed")}
# the reference's logical axes of each parameter by (parent, name), after
# the leading client and layer dims; a classifier's leaves are untagged
_PARAM_AXES = {
    **{("attn", k): v for k, v in _QKV.items()},
    **{("xattn", k): v for k, v in _QKV.items()},
    **{("mlp", k): v for k, v in _MLP.items()},
    **{("shared", k): v for k, v in _MLP.items()},
    ("embed", "table"): ("vocab", "embed"),
    ("dec_embed", "table"): ("vocab", "embed"),
    ("norm", "scale"): ("embed",),
    ("enc_norm", "scale"): ("embed",),
    ("gate_norm", "scale"): ("ssm_inner",),
    ("head", "w"): ("embed", "vocab"),
    ("projector", "w"): ("embed", None),
    ("mamba", "A_log"): ("ssm_heads",),
    ("mamba", "D"): ("ssm_heads",),
    ("mamba", "dt_bias"): ("ssm_heads",),
    ("mamba", "conv_B"): (None, "state"),
    ("mamba", "conv_C"): (None, "state"),
    ("mamba", "conv_x"): (None, "ssm_inner"),
    ("mamba", "wB"): ("embed", "state"),
    ("mamba", "wC"): ("embed", "state"),
    ("mamba", "wdt"): ("embed", "ssm_heads"),
    ("mamba", "wx"): ("embed", "ssm_inner"),
    ("mamba", "wz"): ("embed", "ssm_inner"),
    ("mamba", "wo"): ("ssm_inner", "embed"),
    ("moe", "router"): ("embed", "experts"),
    ("moe", "wg"): ("experts", "embed", "expert_ffn"),
    ("moe", "wu"): ("experts", "embed", "expert_ffn"),
    ("moe", "wd"): ("experts", "expert_ffn", "embed"),
}


def param_axes(cfg: ModelConfig, params: PyTree) -> PyTree:
    """The logical axes of every leaf of an MTSL params tree ({"towers":
    [M, ...], "server": ...}): "client" first on a tower leaf, "layers"
    on each stacked layer dim, then the leaf's own tags."""
    tagged = cfg.family not in ("mlp", "resnet")

    def one(path: str, leaf):
        keys = path.split("/")
        lead = ["client"] if keys[0] == "towers" else []
        tail = _PARAM_AXES.get(tuple(keys[-2:])) if tagged else None
        if tail is None:
            tail = (None,) * (leaf.ndim - len(lead))
        return tuple(lead) + ("layers",) * (leaf.ndim - len(lead) - len(tail)) + tail

    return tree_map_with_path(one, params)


def abstract_mtsl_params(model: Model, num_clients: int, serving: bool = False):
    """(meta params tree, axes tree) for the MTSL layout, no storage;
    `serving` builds the serving dtypes (the inits' serving=True)."""
    gen = torch.Generator()
    kw = {"serving": True} if serving else {}
    with abstract_params():
        params = {
            "towers": stack_towers(lambda g: model.init_tower(g, **kw), gen,
                                   num_clients),
            "server": model.init_server(gen, **kw),
        }
    return params, param_axes(model.cfg, params)


def abstract_opt_state(optimizer, params, params_axes):
    """Optimizer state on meta + axes (momenta share the param layout):
    each state leaf takes the axes of the first parameter of its shape and
    dtype (or of its shape in f32), first in the reference's leaf order
    (dict keys sorted)."""
    with torch.no_grad():
        state = optimizer.init(tree_map(lambda p: p.detach(), params))
    shape_to_axes = {}
    for p, a in zip(_sorted_leaves(params), _sorted_leaves(params_axes)):
        shape_to_axes.setdefault((tuple(p.shape), p.dtype), a)

    def leaf_axes(_, leaf):
        return shape_to_axes.get((tuple(leaf.shape), leaf.dtype),
                                 shape_to_axes.get((tuple(leaf.shape), torch.float32)))

    return state, tree_map_with_path(leaf_axes, state)


def _sorted_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, dict keys sorted (a tuple
    of axis names is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# caches (decode programs)
# ---------------------------------------------------------------------------

_KV_TAIL = ("kv_seq", "kv_heads", None)  # (cap, Hkv, D)
_BASE_RANK = {"k": 4, "v": 4, "conv_x": 3, "conv_B": 3, "conv_C": 3, "state": 4,
              "enc_out": 3}
_TAIL_AXES = {
    "k": _KV_TAIL,
    "v": _KV_TAIL,
    "conv_x": (None, "ssm_inner"),
    "conv_B": (None, None),
    "conv_C": (None, None),
    "state": ("ssm_heads", None, None),
    "enc_out": (None, None),
}


def cache_axes(cache, is_tower: bool):
    """Logical axes for a cache tree by leaf name and rank (the reference's
    rule): [client?][layers?][batch] + tail, client only in tower caches
    stacked over clients."""

    def one(path: str, leaf):
        name = path.split("/")[-1]
        base = _BASE_RANK.get(name)
        if base is None:
            return (None,) * leaf.ndim
        tail = _TAIL_AXES[name]
        extra = leaf.ndim - base
        lead = []
        if is_tower:
            lead.append("client")
            extra -= 1
        lead += ["layers"] * max(extra, 0)
        return tuple(lead) + ("batch",) + tuple(tail)

    return tree_map_with_path(one, cache)


def abstract_caches(model: Model, shape: ShapeConfig, mesh,
                    max_len: Optional[int] = None):
    """(ServeCaches on meta, ServeCaches of axes) for a decode program. The
    tower caches are stacked over the M clients, [M, ...], as the
    reference's are; `tower_caches` splits them into the per-client list
    the port's decode step takes."""
    cfg = model.cfg
    M, b = clients_for(shape, mesh)
    cap = max_len or shape.seq_len
    meta = torch.device("meta")
    tower = tree_map(lambda x: x[None].expand((M,) + tuple(x.shape)).contiguous(),
                     model.init_tower_cache(b, cap, meta))
    server = model.init_server_cache(M * b, cap, meta)
    extras, extras_axes = {}, {}
    if cfg.family == "vlm":
        extras["vis_proj"] = torch.empty((M * b, cfg.vis_seq, cfg.d_model),
                                         dtype=getattr(torch, cfg.dtype), device=meta)
        extras_axes["vis_proj"] = ("batch", None, None)
    caches = ServeCaches(tower=tower, server=server, extras=extras)
    axes = ServeCaches(tower=cache_axes(tower, is_tower=True),
                       server=cache_axes(server, is_tower=False), extras=extras_axes)
    return caches, axes


def tower_caches(caches: ServeCaches, num_clients: int) -> ServeCaches:
    """A ServeCaches with its tower caches stacked [M, ...] as the port's
    decode step takes them: a list of M per-client views."""
    return caches._replace(tower=[tree_map(lambda x, m=m: x[m], caches.tower)
                                  for m in range(num_clients)])
