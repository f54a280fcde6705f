"""Model assembly (port of `repro.models.registry` for `family == "dense"`):
the model is built already split into a client tower (embedding + bottom
`split_layers` blocks) and a server stack (the other blocks + final norm +
head), with the serving hooks of the reference's `Model`.

    tower_prefill(tp, tokens [B,S], max_len)      -> (h [B,S,d], tcache)
    server_prefill(sp, h, max_len)                -> (logits [B,1,V] f32, scache)
    tower_decode(tp, tokens [B,1], tcache, pos, write=None)  -> h [B,1,d]
    server_decode(sp, h, scache, pos, write=None) -> logits [B,1,V] f32
    tower_extend(tp, tokens [B,C], tcache, start) -> h [B,C,d]
    server_extend(sp, h, scache, start, n_valid)  -> logits [B,1,V] f32

The reference passes and returns `{"h": ...}` smashed dicts and new
caches; the port passes the activation tensor and updates caches in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.stacks import make_stack
from repro_torch.nn import param


class Model(NamedTuple):
    cfg: ModelConfig
    init_tower: Callable  # gen -> params (ONE client tower)
    init_server: Callable  # gen -> params
    tower_prefill: Callable
    server_prefill: Callable
    tower_decode: Callable
    server_decode: Callable
    init_tower_cache: Callable  # (batch, cap, device) -> cache
    init_server_cache: Callable
    tower_extend: Callable
    server_extend: Callable


def _decoder_model(cfg: ModelConfig) -> Model:
    kinds = cfg.layer_kinds
    split = cfg.split_layers
    if not 0 < split < cfg.num_layers:
        raise ValueError(f"split_layers={split} must be in (0, {cfg.num_layers})")
    tower_stack = make_stack(cfg, kinds[:split])
    server_stack = make_stack(cfg, kinds[split:])

    def init_tower(gen):
        return {"embed": L.embedding_params(gen, cfg),
                "blocks": tower_stack.init(gen)}

    def init_server(gen):
        return {
            "blocks": server_stack.init(gen),
            "norm": L.rmsnorm_params(gen, cfg.d_model),
            "head": {"w": param(gen, (cfg.d_model, cfg.vocab_size),
                                dtype=L.compute_dtype(cfg))},
        }

    def _head(sp, x):
        x = L.rmsnorm(sp["norm"], x, cfg.norm_eps)
        return L.logits_f32(x, sp["head"]["w"])

    def tower_prefill(tp, tokens, max_len):
        x = L.embed(tp["embed"], tokens, cfg)
        return tower_stack.prefill(tp["blocks"], x, {"max_len": max_len})

    def server_prefill(sp, h, max_len):
        x, cache = server_stack.prefill(sp["blocks"], h, {"max_len": max_len})
        return _head(sp, x[:, -1:]), cache

    def tower_decode(tp, tokens, tcache, pos, write=None):
        x = L.embed(tp["embed"], tokens, cfg)  # [B,1]
        return tower_stack.decode(tp["blocks"], x, tcache,
                                  {"pos": pos, "write": write})

    def server_decode(sp, h, scache, pos, write=None):
        x = server_stack.decode(sp["blocks"], h, scache,
                                {"pos": pos, "write": write})
        return _head(sp, x)

    def tower_extend(tp, tokens, tcache, start):
        x = L.embed(tp["embed"], tokens, cfg)  # [B,C]
        return tower_stack.extend(tp["blocks"], x, tcache, {"start": start})

    def server_extend(sp, h, scache, start, n_valid: int):
        x = server_stack.extend(sp["blocks"], h, scache, {"start": start})
        # logits for each row's LAST REAL chunk token (padded tail is garbage)
        x = x[:, max(int(n_valid) - 1, 0)][:, None]
        return _head(sp, x)

    return Model(
        cfg=cfg,
        init_tower=init_tower,
        init_server=init_server,
        tower_prefill=tower_prefill,
        server_prefill=server_prefill,
        tower_decode=tower_decode,
        server_decode=server_decode,
        init_tower_cache=tower_stack.init_cache,
        init_server_cache=server_stack.init_cache,
        tower_extend=tower_extend,
        server_extend=server_extend,
    )


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        return _decoder_model(cfg)
    raise ValueError(f"family {cfg.family!r} is not ported yet")
