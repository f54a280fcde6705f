"""Layer-stack assembly (port of `repro.models.stacks` for the dense
`full`/`swa` kinds): blocks -> repeating segments -> a Python loop.

The reference stacks the parameters of a segment that repeats (with
`cfg.scan_layers`) along a leading layer axis and runs it under
`lax.scan`. The port keeps the same segmentation and `seg{i}` keys but
holds such a segment unstacked, as a list with one unit dict per repeat,
and loops over it; a segment that does not repeat is one unit dict, as in
the reference. Caches mirror the parameter tree and are updated in place
by decode/extend.

ctx keys: "max_len" (prefill), "pos" and optional "write" (decode),
"start" (extend).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

PyTree = Any


class Block(NamedTuple):
    init: Callable  # gen -> params
    prefill: Callable  # (p, x, ctx) -> (x, cache)
    decode: Callable  # (p, x_t, cache, ctx) -> x_t (cache updated in place)
    init_cache: Callable  # (batch, cap, device) -> cache
    extend: Callable  # (p, x_c, cache, ctx) -> x_c (cache updated in place)


def _attn_mlp_block(cfg: ModelConfig, window: int) -> Block:
    def init(gen):
        return {"attn": L.attn_params(gen, cfg), "mlp": L.mlp_params(gen, cfg)}

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
        return L.init_attn_cache(cfg, batch, cap, device)

    def extend(p, x_c, cache, ctx):
        x_c = x_c + L.attn_extend(p["attn"], x_c, cache, ctx["start"], cfg,
                                  window=window)
        return x_c + L.mlp_forward(p["mlp"], x_c, cfg)

    return Block(init, prefill, decode, init_cache, extend)


def make_block(cfg: ModelConfig, kind: str) -> Block:
    if kind == "full":
        return _attn_mlp_block(cfg, window=0)
    if kind == "swa":
        return _attn_mlp_block(cfg, window=cfg.sliding_window)
    raise ValueError(f"block kind {kind!r} is not ported yet")


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
    init: Callable  # gen -> params
    prefill: Callable  # (p, x, ctx) -> (x, caches)
    decode: Callable  # (p, x_t, caches, ctx) -> x_t
    extend: Callable  # (p, x_c, caches, ctx) -> x_c
    init_cache: Callable  # (batch, cap, device) -> caches


def make_stack(cfg: ModelConfig, kinds: Sequence[str]) -> Stack:
    segments = stack_segments(cfg, kinds)
    seg_blocks = [tuple(make_block(cfg, k) for k in unit) for unit, _ in segments]
    seg_repeats = [r for _, r in segments]

    def _units(tree, si):
        """The unit trees of segment si: one per repeat."""
        t = tree[f"seg{si}"]
        return t if seg_repeats[si] > 1 else [t]

    def _pack(units, si):
        return units if seg_repeats[si] > 1 else units[0]

    def init(gen):
        p = {}
        for si, blocks in enumerate(seg_blocks):
            units = [{str(j): b.init(gen) for j, b in enumerate(blocks)}
                     for _ in range(seg_repeats[si])]
            p[f"seg{si}"] = _pack(units, si)
        return p

    def prefill(p, x, ctx):
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
        for si, blocks in enumerate(seg_blocks):
            for px, cx in zip(_units(p, si), _units(caches, si)):
                for j, b in enumerate(blocks):
                    x_t = b.decode(px[str(j)], x_t, cx[str(j)], ctx)
        return x_t

    def extend(p, x_c, caches, ctx):
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

    return Stack(init, prefill, decode, extend, init_cache)
