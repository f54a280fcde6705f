"""Layer-stack assembly (port of `repro.models.stacks`): blocks ->
repeating segments -> a Python loop.

Block kinds: `full`, `swa` (causal self-attention + MLP), `bidir`
(non-causal self-attention + MLP: the encoder blocks), `cross` (causal
self-attention, cross attention to ctx["xattn"], MLP: the VLM's image
layers and the encoder-decoder's decoder), `moe` (causal self-attention +
the MoE layer), `dense_moe_lead` (an MoE model's leading dense layers:
`full` at cfg.d_ff), `mamba` and `shared_attn`.

The reference stacks the parameters of a segment that repeats (with
`cfg.scan_layers`) along a leading layer axis and runs it under
`lax.scan`. The port keeps the same segmentation and `seg{i}` keys but
holds such a segment unstacked, as a list with one unit dict per repeat,
and loops over it; a segment that does not repeat is one unit dict, as in
the reference. Caches mirror the parameter tree and are updated in place
by decode/extend.

Each block's training forward returns (x, aux): aux is the MoE block's
router balance loss times cfg.router_aux_weight, 0.0 for every other kind.
The stack sums aux over its blocks, as the reference's scan carries it.

The training forward rematerialises per segment unit, as the reference's
`_remat` wraps each unit (the scan body): `cfg.remat` "block" runs each
unit under `torch.utils.checkpoint` (non-reentrant: only the unit's input
is kept, and its backward reruns the unit's forward, which returns the
unit's aux beside x); "full" shares that code, since the reference's
`nothing_saveable` policy also keeps only the unit's inputs; "none" is a
plain call. Without `cfg.scan_layers` the whole stack is one unit, as in
the reference.

Zamba2's *shared* attention block is loop-invariant: its parameters live
at the stack level ("shared") and reach each `shared_attn` layer through
ctx["shared"] (in every mode: the stack puts them there).

Serving (prefill / decode / caches) is ported for every kind but
`bidir` (the encoder blocks, which serving runs through their forward);
extend for every kind but `bidir` and `cross`, as in the reference.

ctx keys: "shared" (every mode), "xattn" (forward, prefill, decode),
"max_len" (prefill), "pos" and optional "write" and "rows_alone"
(decode), "start" and "n_valid" (extend).
"""
from __future__ import annotations

import contextlib

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_forward, moe_params, round_tokens, round_tokens_group
from repro_torch.models.ssm import (
    init_mamba_cache,
    mamba_decode,
    mamba_extend,
    mamba_forward,
    mamba_params,
    mamba_prefill,
)

PyTree = Any


class Block(NamedTuple):
    init: Callable  # (gen, serving) -> params
    forward: Callable  # (p, x, ctx) -> (x, aux) (training)
    # serving; None for a kind whose serving is not ported
    prefill: Optional[Callable] = None  # (p, x, ctx) -> (x, cache)
    decode: Optional[Callable] = None  # (p, x_t, cache, ctx) -> x_t (in place)
    init_cache: Optional[Callable] = None  # (batch, cap, device) -> cache
    extend: Optional[Callable] = None  # (p, x_c, cache, ctx) -> x_c (in place)


def _attn_mlp_block(cfg: ModelConfig, window: int, causal: bool = True) -> Block:
    def init(gen, serving):
        return {"attn": L.attn_params(gen, cfg, serving),
                "mlp": L.mlp_params(gen, cfg, serving=serving)}

    def forward(p, x, ctx):
        x = x + L.attn_forward(p["attn"], x, cfg, window=window, causal=causal)
        return x + L.mlp_forward(p["mlp"], x, cfg), 0.0

    if not causal:  # the encoder blocks run their forward when served
        return Block(init, forward)

    def prefill(p, x, ctx):
        a, cache = L.attn_prefill(p["attn"], x, cfg, window=window,
                                  max_len=ctx["max_len"])
        x = x + a
        return x + L.mlp_forward(p["mlp"], x, cfg), cache

    def decode(p, x_t, cache, ctx):
        x_t = x_t + L.attn_decode(p["attn"], x_t, cache, ctx["pos"], cfg,
                                  window=window, write=ctx.get("write"))
        return x_t + L.mlp_forward(p["mlp"], x_t, cfg)

    def init_cache(batch, cap, device):
        return L.init_attn_cache(cfg, batch, cap, device, window=window)

    def extend(p, x_c, cache, ctx):
        x_c = x_c + L.attn_extend(p["attn"], x_c, cache, ctx["start"], cfg,
                                  window=window)
        return x_c + L.mlp_forward(p["mlp"], x_c, cfg)

    return Block(init, forward, prefill, decode, init_cache, extend)


def _cross_block(cfg: ModelConfig) -> Block:
    """Causal self-attention + cross attention to ctx["xattn"] + MLP (the
    VLM's image layers, the encoder-decoder's decoder blocks). Served with
    a KV cache for the self-attention only: the cross attention projects
    ctx["xattn"] again at every step, as the reference does. No extend, as
    in the reference."""

    def init(gen, serving):
        return {"attn": L.attn_params(gen, cfg, serving),
                "xattn": L.attn_params(gen, cfg, serving),
                "mlp": L.mlp_params(gen, cfg, serving=serving)}

    def forward(p, x, ctx):
        x = x + L.attn_forward(p["attn"], x, cfg)
        x = x + L.attn_forward(p["xattn"], x, cfg, kv_src=ctx["xattn"])
        return x + L.mlp_forward(p["mlp"], x, cfg), 0.0

    def prefill(p, x, ctx):
        a, cache = L.attn_prefill(p["attn"], x, cfg, max_len=ctx["max_len"])
        x = x + a
        x = x + L.attn_forward(p["xattn"], x, cfg, kv_src=ctx["xattn"])
        return x + L.mlp_forward(p["mlp"], x, cfg), cache

    def decode(p, x_t, cache, ctx):
        x_t = x_t + L.attn_decode(p["attn"], x_t, cache, ctx["pos"], cfg,
                                  write=ctx.get("write"))
        x_t = x_t + L.attn_decode(p["xattn"], x_t, None, None, cfg,
                                  kv_src=ctx["xattn"])
        return x_t + L.mlp_forward(p["mlp"], x_t, cfg)

    def init_cache(batch, cap, device):
        return L.init_attn_cache(cfg, batch, cap, device)

    return Block(init, forward, prefill, decode, init_cache)


def _moe_block(cfg: ModelConfig) -> Block:
    """Causal self-attention + the MoE layer. The MoE dispatches a call's
    tokens as one group (cfg.moe_groups aside), except in a decode whose
    ctx["rows_alone"] is set: each row's token is then a group of its own,
    as when the reference vmaps a decode over slots."""

    def init(gen, serving):
        return {"attn": L.attn_params(gen, cfg, serving),
                "moe": moe_params(gen, cfg, serving)}

    def forward(p, x, ctx):
        x = x + L.attn_forward(p["attn"], x, cfg)
        y, aux = moe_forward(p["moe"], x, cfg)
        return x + y, aux * cfg.router_aux_weight

    def prefill(p, x, ctx):
        a, cache = L.attn_prefill(p["attn"], x, cfg, max_len=ctx["max_len"])
        x = x + a
        return x + moe_forward(p["moe"], x, cfg)[0], cache

    def decode(p, x_t, cache, ctx):
        x_t = x_t + L.attn_decode(p["attn"], x_t, cache, ctx["pos"], cfg,
                                  write=ctx.get("write"))
        groups = x_t.shape[0] if ctx.get("rows_alone") else None
        return x_t + moe_forward(p["moe"], x_t, cfg, groups=groups)[0]

    def init_cache(batch, cap, device):
        return L.init_attn_cache(cfg, batch, cap, device)

    def extend(p, x_c, cache, ctx):
        x_c = x_c + L.attn_extend(p["attn"], x_c, cache, ctx["start"], cfg)
        return x_c + moe_forward(p["moe"], x_c, cfg)[0]

    return Block(init, forward, prefill, decode, init_cache, extend)


def _mamba_block(cfg: ModelConfig) -> Block:
    def init(gen, serving):
        return {"mamba": mamba_params(gen, cfg, serving)}

    def forward(p, x, ctx):
        return x + mamba_forward(p["mamba"], x, cfg), 0.0

    def prefill(p, x, ctx):
        y, cache = mamba_prefill(p["mamba"], x, cfg)
        return x + y, cache

    def decode(p, x_t, cache, ctx):
        return x_t + mamba_decode(p["mamba"], x_t, cache, cfg,
                                  write=ctx.get("write"))

    def init_cache(batch, cap, device):
        return init_mamba_cache(cfg, batch, device)

    def extend(p, x_c, cache, ctx):
        return x_c + mamba_extend(p["mamba"], x_c, cache, ctx["n_valid"], cfg)

    return Block(init, forward, prefill, decode, init_cache, extend)


def _shared_attn_block(cfg: ModelConfig) -> Block:
    """Zamba2-style layer: apply the stack-level *shared* attention+MLP
    block (params from ctx["shared"]; its own KV cache per application),
    then its own mamba. Cache: {"attn", "mamba"}."""
    mamba = _mamba_block(cfg)

    def forward(p, x, ctx):
        sp = ctx["shared"]
        x = x + L.attn_forward(sp["attn"], x, cfg)
        x = x + L.mlp_forward(sp["mlp"], x, cfg)
        return mamba.forward(p, x, ctx)

    def prefill(p, x, ctx):
        sp = ctx["shared"]
        a, acache = L.attn_prefill(sp["attn"], x, cfg, max_len=ctx["max_len"])
        x = x + a
        x = x + L.mlp_forward(sp["mlp"], x, cfg)
        x, mcache = mamba.prefill(p, x, ctx)
        return x, {"attn": acache, "mamba": mcache}

    def decode(p, x_t, cache, ctx):
        sp = ctx["shared"]
        x_t = x_t + L.attn_decode(sp["attn"], x_t, cache["attn"], ctx["pos"],
                                  cfg, write=ctx.get("write"))
        x_t = x_t + L.mlp_forward(sp["mlp"], x_t, cfg)
        return mamba.decode(p, x_t, cache["mamba"], ctx)

    def init_cache(batch, cap, device):
        return {"attn": L.init_attn_cache(cfg, batch, cap, device),
                "mamba": init_mamba_cache(cfg, batch, device)}

    def extend(p, x_c, cache, ctx):
        sp = ctx["shared"]
        x_c = x_c + L.attn_extend(sp["attn"], x_c, cache["attn"], ctx["start"], cfg)
        x_c = x_c + L.mlp_forward(sp["mlp"], x_c, cfg)
        return mamba.extend(p, x_c, cache["mamba"], ctx)

    return Block(mamba.init, forward, prefill, decode, init_cache, extend)


def make_block(cfg: ModelConfig, kind: str) -> Block:
    if kind in ("full", "dense_moe_lead"):
        return _attn_mlp_block(cfg, window=0)
    if kind == "swa":
        return _attn_mlp_block(cfg, window=cfg.sliding_window)
    if kind == "bidir":  # encoder blocks (whisper): non-causal attention
        return _attn_mlp_block(cfg, window=0, causal=False)
    if kind == "cross":
        return _cross_block(cfg)
    if kind == "moe":
        return _moe_block(cfg)
    if kind == "mamba":
        return _mamba_block(cfg)
    if kind == "shared_attn":
        return _shared_attn_block(cfg)
    raise ValueError(f"unknown block kind {kind!r}")


def segment_layers(kinds: Sequence[str], max_unit: int = 12):
    """Greedy maximal-repeat segmentation -> [(unit_kinds, repeats), ...]."""
    kinds = tuple(kinds)
    segments = []
    i, n = 0, len(kinds)
    while i < n:
        best_u, best_r = 1, 1
        for u in range(1, min(n - i, max_unit) + 1):
            r = 1
            while i + (r + 1) * u <= n and kinds[i + r * u : i + (r + 1) * u] == kinds[i : i + u]:
                r += 1
            if u * r > best_u * best_r or (u * r == best_u * best_r and u < best_u):
                best_u, best_r = u, r
        segments.append((kinds[i : i + best_u], best_r))
        i += best_u * best_r
    return segments


def stack_segments(cfg: ModelConfig, kinds: Sequence[str]):
    """[(unit_kinds, repeats)] as the stack lays them out: the greedy
    segmentation under cfg.scan_layers, else one unrolled unit."""
    kinds = tuple(kinds)
    if not cfg.scan_layers:
        return [(kinds, 1)]
    return segment_layers(kinds)


class Stack(NamedTuple):
    init: Callable  # (gen, serving=False) -> params
    forward: Callable  # (p, x, ctx) -> (x, aux)
    prefill: Callable  # (p, x, ctx) -> (x, caches)
    decode: Callable  # (p, x_t, caches, ctx) -> x_t
    # chunked-prefill continuation; None when any layer kind lacks extend
    extend: Optional[Callable]  # (p, x_c, caches, ctx) -> x_c
    init_cache: Callable  # (batch, cap, device) -> caches


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """The unit function under cfg.remat (see the module docstring)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("block", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r}")

    def unit(*args):
        # the recompute dispatches its MoE layers over the tokens the
        # forward saw (models.moe.round_tokens), wherever the backward runs
        group = round_tokens_group()
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              round_tokens(group)))

    return unit


def make_stack(cfg: ModelConfig, kinds: Sequence[str]) -> Stack:
    """A stack over `kinds`. Where `kinds` holds `shared_attn` layers, a
    stack-level shared attention+MLP block is created and passed to the
    layers through ctx["shared"]. A stack with a kind that has no serving
    path (`bidir`) refuses prefill, decode and init_cache; its extend,
    like that of a stack with a kind that cannot extend (`cross`), is
    None, as the reference's."""
    has_shared = "shared_attn" in kinds
    segments = stack_segments(cfg, kinds)
    seg_blocks = [tuple(make_block(cfg, k) for k in unit) for unit, _ in segments]
    seg_repeats = [r for _, r in segments]
    serves = all(b.prefill is not None for blocks in seg_blocks for b in blocks)
    can_extend = all(b.extend is not None for blocks in seg_blocks for b in blocks)

    def _serving(fn):
        if serves:
            return fn

        def refuse(*args, **kwargs):
            raise NotImplementedError(
                f"block kinds {sorted(set(kinds))} have no serving path")
        return refuse

    def _units(tree, si):
        """The unit trees of segment si: one per repeat."""
        t = tree[f"seg{si}"]
        return t if seg_repeats[si] > 1 else [t]

    def _pack(units, si):
        return units if seg_repeats[si] > 1 else units[0]

    def init(gen, serving: bool = False):
        p = {}
        if has_shared:
            p["shared"] = {"attn": L.attn_params(gen, cfg, serving),
                           "mlp": L.mlp_params(gen, cfg, serving=serving)}
        for si, blocks in enumerate(seg_blocks):
            units = [{str(j): b.init(gen, serving) for j, b in enumerate(blocks)}
                     for _ in range(seg_repeats[si])]
            p[f"seg{si}"] = _pack(units, si)
        return p

    def _with_shared(p, ctx):
        return dict(ctx, shared=p["shared"]) if has_shared else ctx

    def forward(p, x, ctx):
        ctx = _with_shared(p, ctx)
        aux_total = 0.0
        for si, blocks in enumerate(seg_blocks):
            def unit_fwd(px, x, blocks=blocks):
                aux = 0.0
                for j, b in enumerate(blocks):
                    x, a = b.forward(px[str(j)], x, ctx)
                    aux = aux + a
                return x, aux

            unit_fwd = _remat(unit_fwd, cfg)
            for px in _units(p, si):
                x, a = unit_fwd(px, x)
                aux_total = aux_total + a
        if not torch.is_tensor(aux_total):  # no MoE block: a 0.0 of f32
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux_total

    def prefill(p, x, ctx):
        ctx = _with_shared(p, ctx)
        caches = {}
        for si, blocks in enumerate(seg_blocks):
            unit_caches = []
            for px in _units(p, si):
                cs = {}
                for j, b in enumerate(blocks):
                    x, cs[str(j)] = b.prefill(px[str(j)], x, ctx)
                unit_caches.append(cs)
            caches[f"seg{si}"] = _pack(unit_caches, si)
        return x, caches

    def decode(p, x_t, caches, ctx):
        ctx = _with_shared(p, ctx)
        for si, blocks in enumerate(seg_blocks):
            for px, cx in zip(_units(p, si), _units(caches, si)):
                for j, b in enumerate(blocks):
                    x_t = b.decode(px[str(j)], x_t, cx[str(j)], ctx)
        return x_t

    def extend(p, x_c, caches, ctx):
        ctx = _with_shared(p, ctx)
        for si, blocks in enumerate(seg_blocks):
            for px, cx in zip(_units(p, si), _units(caches, si)):
                for j, b in enumerate(blocks):
                    x_c = b.extend(px[str(j)], x_c, cx[str(j)], ctx)
        return x_c

    def init_cache(batch, cap, device):
        caches = {}
        for si, blocks in enumerate(seg_blocks):
            units = [{str(j): b.init_cache(batch, cap, device)
                      for j, b in enumerate(blocks)}
                     for _ in range(seg_repeats[si])]
            caches[f"seg{si}"] = _pack(units, si)
        return caches

    return Stack(init, forward, _serving(prefill), _serving(decode),
                 extend if can_extend else None, _serving(init_cache))
