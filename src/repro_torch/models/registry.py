"""Model assembly (port of `repro.models.registry`): every model is built
already split into a client tower and a server stack.

Training hooks, for the paper classifiers (`family` "mlp" / "resnet",
`models/classifiers.py`), on `[b, ...]` inputs of one client:

    tower_forward(tp, {"image": ...})   -> {"h": smashed}
    server_forward(sp, {"h": ...})      -> (logits [B, C], aux loss)

Training hooks, for the decoder LMs (`family` "dense" / "moe" / "ssm" /
"hybrid" / "vlm": embedding + bottom `split_layers` blocks in the tower;
the other blocks + final norm + head on the server), on `[b, S]` tokens
of one client:

    tower_forward(tp, {"tokens": ...})  -> {"h": [b, S, d]}
    server_forward(sp, {"h": ...})      -> (logits [B, S, V] f32, aux loss)

The VLM's tower also projects the client's vision features
(`{"vis": [b, Sv, vis_dim]}`, the stub frontend) to d_model and uploads
them beside h as `"vis_proj"`; every `cross` layer, in the tower or on the
server, attends to them. The encoder-decoder (`family` "encdec", whisper)
puts the bottom `split_layers` encoder blocks in the tower, over
`{"frames": [b, Se, d], "tokens": [b, S]}`, and uploads `{"h", "tokens"}`
(MTSL uploads the labels); the server runs the other encoder blocks, the
encoder norm, and the decoder (embedding, `cross` blocks over the encoder's
output, norm, head). The MoE blocks' aux loss comes back from
server_forward (the tower's is dropped, as the reference drops it).

Serving hooks, for every LM family, pass the reference's dicts:

    tower_prefill(tp, inputs, max_len)           -> (smashed, tcache)
    server_prefill(sp, smashed, max_len)         -> (logits [B,1,V] f32, scache)
    tower_decode(tp, inputs_t, tcache, pos, write=None, rows_alone=False)
                                                 -> smashed_t
    server_decode(sp, smashed_t, scache, pos, write=None) -> logits [B,1,V] f32
    tower_extend(tp, inputs_c, tcache, start, n_valid) -> smashed_c
    server_extend(sp, smashed_c, scache, start, n_valid) -> logits [B,1,V] f32

`inputs` is {"tokens": [B,S]} plus the VLM's {"vis"} or the
encoder-decoder's {"frames"}; `inputs_t` / `inputs_c` carry the next
token(s), and the VLM's decode also the {"vis_proj"} its prefill
uploaded (the engines keep it beside the caches). The smashed dicts are
{"h"} (+ "vis_proj" for the VLM); the encoder-decoder's tower uploads
{"h", "tokens"} at prefill and passes {"tokens"} through at decode, and
its server caches {"dec": the decoder's caches, "enc_out": the
encoder's output}. `n_valid` counts the real tokens of the chunk: the
Mamba blocks of the ssm and hybrid stacks neutralise the padded steps
with it (an int, or a [B] tensor of one per row), and server_extend takes
the logits at the last real token. `start` and `n_valid` may be device
tensors (the continuous engine's captured extend step reads them from its
static buffers), and then nothing on the path reads them on the host. `write` ([B] bool) freezes the caches of the rows
where it is False. `rows_alone` dispatches each row's token through the
tower's MoE layers as its own group (the reference's continuous engine
vmaps the tower decode over slots). The reference returns new caches; the
port updates them in place. The VLM and the encoder-decoder have no
extend (their hooks are None), as in the reference.

A decoder's `init_tower(gen, serving=False)` / `init_server(gen,
serving=False)` give the training tree (every leaf in cfg.param_dtype, as
the reference's); `serving=True` gives the serving tree of the engines
(matmul weights in cfg.dtype; `models/layers.py`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode.ref import per_row
from repro_torch.models import layers as L
from repro_torch.models.stacks import make_stack
from repro_torch.nn import param


class Model(NamedTuple):
    cfg: ModelConfig
    init_tower: Callable  # gen -> params (ONE client tower)
    init_server: Callable  # gen -> params
    # training
    tower_forward: Optional[Callable] = None
    server_forward: Optional[Callable] = None
    # serving (every LM family; inits take serving=True)
    tower_prefill: Optional[Callable] = None
    server_prefill: Optional[Callable] = None
    tower_decode: Optional[Callable] = None
    server_decode: Optional[Callable] = None
    init_tower_cache: Optional[Callable] = None  # (batch, cap, device) -> cache
    init_server_cache: Optional[Callable] = None
    # chunked-prefill continuation (continuous batching); None when the
    # family cannot extend a partial cache (vlm, encdec)
    tower_extend: Optional[Callable] = None
    server_extend: Optional[Callable] = None


def stack_kinds(cfg: ModelConfig) -> dict:
    """{(side, key): block kinds} of every layer stack of an LM: the tree
    at params[side][key] is a stack over those kinds."""
    split = cfg.split_layers
    if cfg.family == "encdec":
        if not 0 < split <= cfg.encoder_layers:
            raise ValueError(f"split_layers={split} must be in "
                             f"(0, {cfg.encoder_layers}]")
        out = {("tower", "blocks"): ("bidir",) * split,
               ("server", "dec_blocks"): ("cross",) * cfg.num_layers}
        if cfg.encoder_layers > split:
            out[("server", "enc_blocks")] = ("bidir",) * (cfg.encoder_layers - split)
        return out
    if not 0 < split < cfg.num_layers:
        raise ValueError(f"split_layers={split} must be in (0, {cfg.num_layers})")
    kinds = cfg.layer_kinds
    return {("tower", "blocks"): kinds[:split], ("server", "blocks"): kinds[split:]}


def _decoder_model(cfg: ModelConfig) -> Model:
    kinds = stack_kinds(cfg)
    tower_stack = make_stack(cfg, kinds[("tower", "blocks")])
    server_stack = make_stack(cfg, kinds[("server", "blocks")])
    is_vlm = cfg.family == "vlm"

    def init_tower(gen, serving: bool = False):
        p = {"embed": L.embedding_params(gen, cfg),
             "blocks": tower_stack.init(gen, serving)}
        if is_vlm:
            p["projector"] = {"w": param(gen, (cfg.vis_dim, cfg.d_model),
                                         dtype=L.weight_dtype(cfg, serving))}
        return p

    def init_server(gen, serving: bool = False):
        return {
            "blocks": server_stack.init(gen, serving),
            "norm": L.rmsnorm_params(gen, cfg.d_model),
            "head": {"w": param(gen, (cfg.d_model, cfg.vocab_size),
                                dtype=L.weight_dtype(cfg, serving))},
        }

    def _head(sp, x):
        x = L.rmsnorm(sp["norm"], x, cfg.norm_eps)
        return L.logits_f32(x, sp["head"]["w"])

    def _embed_and_project(tp, inputs):
        """The embedded tokens, and for the VLM the projected vision
        features {"vis_proj"} that the tower uploads."""
        x = L.embed(tp["embed"], inputs["tokens"], cfg)
        if not is_vlm:
            return x, {}
        return x, {"vis_proj": inputs["vis"].to(x.dtype)
                   @ tp["projector"]["w"].to(x.dtype)}

    def _xattn(smashed):
        return {"xattn": smashed["vis_proj"]} if is_vlm else {}

    def tower_forward(tp, inputs):
        x, extras = _embed_and_project(tp, inputs)
        x, _ = tower_stack.forward(tp["blocks"], x, _xattn(extras))
        return {"h": x, **extras}

    def server_forward(sp, smashed):
        x, aux = server_stack.forward(sp["blocks"], smashed["h"], _xattn(smashed))
        return _head(sp, x), aux

    def tower_prefill(tp, inputs, max_len):
        x, extras = _embed_and_project(tp, inputs)
        x, cache = tower_stack.prefill(tp["blocks"], x,
                                       {"max_len": max_len, **_xattn(extras)})
        return {"h": x, **extras}, cache

    def server_prefill(sp, smashed, max_len):
        x, cache = server_stack.prefill(sp["blocks"], smashed["h"],
                                        {"max_len": max_len, **_xattn(smashed)})
        return _head(sp, x[:, -1:]), cache

    def tower_decode(tp, inputs_t, tcache, pos, write=None, rows_alone=False):
        x = L.embed(tp["embed"], inputs_t["tokens"], cfg)  # [B,1]
        extras = {"vis_proj": inputs_t["vis_proj"]} if is_vlm else {}
        x = tower_stack.decode(tp["blocks"], x, tcache,
                               {"pos": pos, "write": write,
                                "rows_alone": rows_alone, **_xattn(extras)})
        return {"h": x, **extras}

    def server_decode(sp, smashed_t, scache, pos, write=None):
        x = server_stack.decode(sp["blocks"], smashed_t["h"], scache,
                                {"pos": pos, "write": write, **_xattn(smashed_t)})
        return _head(sp, x)

    def tower_extend(tp, inputs_c, tcache, start, n_valid):
        x = L.embed(tp["embed"], inputs_c["tokens"], cfg)  # [B,C]
        x = tower_stack.extend(tp["blocks"], x, tcache,
                               {"start": start, "n_valid": n_valid})
        return {"h": x}

    def server_extend(sp, smashed_c, scache, start, n_valid):
        x = server_stack.extend(sp["blocks"], smashed_c["h"], scache,
                                {"start": start, "n_valid": n_valid})
        # logits for each row's LAST REAL chunk token (padded tail is garbage)
        if torch.is_tensor(n_valid):  # gathered on the device: no host read
            last = per_row(n_valid, x.shape[0], x.device).long().clamp(min=1) - 1
            x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        else:
            x = x[:, max(int(n_valid) - 1, 0)][:, None]
        return _head(sp, x)

    can_extend = (not is_vlm and tower_stack.extend is not None
                  and server_stack.extend is not None)
    return Model(
        cfg=cfg,
        init_tower=init_tower,
        init_server=init_server,
        tower_forward=tower_forward,
        server_forward=server_forward,
        tower_prefill=tower_prefill,
        server_prefill=server_prefill,
        tower_decode=tower_decode,
        server_decode=server_decode,
        init_tower_cache=tower_stack.init_cache,
        init_server_cache=server_stack.init_cache,
        tower_extend=tower_extend if can_extend else None,
        server_extend=server_extend if can_extend else None,
    )


def _encdec_model(cfg: ModelConfig) -> Model:
    kinds = stack_kinds(cfg)
    tower_stack = make_stack(cfg, kinds[("tower", "blocks")])
    enc_kinds = kinds.get(("server", "enc_blocks"))
    enc_top_stack = make_stack(cfg, enc_kinds) if enc_kinds else None
    dec_stack = make_stack(cfg, kinds[("server", "dec_blocks")])

    def init_tower(gen, serving: bool = False):
        return {"blocks": tower_stack.init(gen, serving)}

    def init_server(gen, serving: bool = False):
        p = {}
        if enc_top_stack is not None:
            p["enc_blocks"] = enc_top_stack.init(gen, serving)
        p["enc_norm"] = L.rmsnorm_params(gen, cfg.d_model)
        p["dec_embed"] = L.embedding_params(gen, cfg)
        p["dec_blocks"] = dec_stack.init(gen, serving)
        p["norm"] = L.rmsnorm_params(gen, cfg.d_model)
        p["head"] = {"w": param(gen, (cfg.d_model, cfg.vocab_size),
                                dtype=L.weight_dtype(cfg, serving))}
        return p

    def tower_forward(tp, inputs):
        # frames: [b, Se, d_model] stub frame embeddings; the tokens ride
        # along in the smashed data (MTSL uploads the labels to the server)
        x = inputs["frames"].to(L.compute_dtype(cfg))
        x, _ = tower_stack.forward(tp["blocks"], x, {})
        return {"h": x, "tokens": inputs["tokens"]}

    def _encode_top(sp, h):
        if enc_top_stack is not None:
            h, _ = enc_top_stack.forward(sp["enc_blocks"], h, {})
        return L.rmsnorm(sp["enc_norm"], h, cfg.norm_eps)

    def _head(sp, y):
        y = L.rmsnorm(sp["norm"], y, cfg.norm_eps)
        return L.logits_f32(y, sp["head"]["w"])

    def server_forward(sp, smashed):
        enc_out = _encode_top(sp, smashed["h"])
        y = L.embed(sp["dec_embed"], smashed["tokens"], cfg)
        y, aux = dec_stack.forward(sp["dec_blocks"], y, {"xattn": enc_out})
        return _head(sp, y), aux

    def tower_prefill(tp, inputs, max_len):
        # the tower's encoder blocks run once over the frames
        return tower_forward(tp, inputs), {}

    def server_prefill(sp, smashed, max_len):
        enc_out = _encode_top(sp, smashed["h"])
        y = L.embed(sp["dec_embed"], smashed["tokens"], cfg)
        y, cache = dec_stack.prefill(sp["dec_blocks"], y,
                                     {"xattn": enc_out, "max_len": max_len})
        return _head(sp, y[:, -1:]), {"dec": cache, "enc_out": enc_out}

    def tower_decode(tp, inputs_t, tcache, pos, write=None, rows_alone=False):
        # the encoder is static during decode; only the next token travels
        return {"tokens": inputs_t["tokens"]}

    def server_decode(sp, smashed_t, scache, pos, write=None):
        y = L.embed(sp["dec_embed"], smashed_t["tokens"], cfg)  # [B,1]
        y = dec_stack.decode(sp["dec_blocks"], y, scache["dec"],
                             {"xattn": scache["enc_out"], "pos": pos,
                              "write": write})
        return _head(sp, y)

    def init_server_cache(batch, cap, device):
        return {"dec": dec_stack.init_cache(batch, cap, device),
                "enc_out": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                       dtype=L.compute_dtype(cfg), device=device)}

    return Model(
        cfg=cfg,
        init_tower=init_tower,
        init_server=init_server,
        tower_forward=tower_forward,
        server_forward=server_forward,
        tower_prefill=tower_prefill,
        server_prefill=server_prefill,
        tower_decode=tower_decode,
        server_decode=server_decode,
        init_tower_cache=lambda batch, cap, device: {},
        init_server_cache=init_server_cache,
    )


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "ssm", "hybrid", "vlm"):
        return _decoder_model(cfg)
    if cfg.family == "encdec":
        return _encdec_model(cfg)
    if cfg.family == "mlp":
        from repro_torch.models.classifiers import mlp_model

        return mlp_model(cfg)
    if cfg.family == "resnet":
        from repro_torch.models.classifiers import resnet_model

        return resnet_model(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
