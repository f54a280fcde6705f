"""Shared building blocks of the decoder models (port of
`repro.models.layers`): norms, RoPE, embeddings, GQA self-attention (the
training forward and the serving paths with KV caches), SwiGLU MLP.
Parameters are plain tensors in dicts with the reference's keys and
layouts (dense `w[din, dout]`, `wq[d, H, D]`).

Two parameter trees, asked for with `serving=`:
  * training (`serving=False`, the reference's tree): every leaf in
    `cfg.param_dtype` (f32 masters), each matmul weight cast to
    `cfg.dtype` at its use, as the reference casts;
  * serving (`serving=True`): matmul weights stored in `cfg.dtype` once
    (the same values the cast would give, at half the memory in bf16);
    embedding tables and norm scales stay f32, because the reference
    scales the f32 embedding row before rounding and applies norm scales
    in f32.
The apply functions cast every matmul weight to the activation's dtype,
which is a no-op on a serving tree.

Attention execution modes:
  - forward: the training path over the whole sequence: causal self-
             attention (+ sliding window), non-causal self-attention
             (encoder blocks) or cross attention to `kv_src` (no mask, no
             rope), always through the flash-attention wrapper (K2: the
             CUDA kernel on CUDA tensors)
  - prefill: full sequence, causal (+ sliding window), returns a KV cache
             (a ring of `window` slots under cfg.decode_long_window);
             through K2 under cfg.attn_impl = "chunked"
  - decode:  one token per row against the row's cache slot, per-row
             positions, or cross attention of the token to `kv_src`;
             always through the flash-decode wrapper (K4)
  - extend:  a chunk of C tokens per row appended to a partial cache
Prefill and extend are self-attention only. Decode and extend
write K/V into the cache IN PLACE (the reference returns
a new cache); decode takes an optional per-row `write` mask so frozen rows
keep their cache, as the reference's where-masked update does.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.counts import register
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import per_row
from repro_torch.nn import param


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def weight_dtype(cfg: ModelConfig, serving: bool) -> torch.dtype:
    """Storage dtype of a matmul weight: cfg.dtype in a serving tree,
    cfg.param_dtype in a training tree (see the module docstring)."""
    return compute_dtype(cfg) if serving else param_dtype(cfg)


# ---------------------------------------------------------------------------
# norms / rope / embedding / logits
# ---------------------------------------------------------------------------


def rmsnorm_params(gen, d):
    return {"scale": param(gen, (d,), init="ones", dtype=torch.float32)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """[half] f32 frequencies, built on the CPU once per (theta, half,
    device): a host->device copy per call would stall the host. The one
    copy goes through pinned memory, so it does not wait on the card
    either (a serving step's warm-up makes it before its capture)."""
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32) / half)
    if device.type != "cuda":
        return freqs.to(device)
    return freqs.pin_memory().to(device, non_blocking=True)


def rope(x, positions, theta: float):
    """Rotary embedding. x: [..., S, H, D]; positions: broadcastable to
    [..., S]. Frequencies are exp(-log(theta) * i / half) in f32, the
    reference's formula (not theta ** (-i / half), which rounds apart)."""
    D = x.shape[-1]
    half = D // 2
    ang = positions[..., None].float() * _rope_freqs(theta, half, x.device)
    ang = ang[..., None, :]  # broadcast over heads: [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def embedding_params(gen, cfg: ModelConfig):
    return {"table": param(gen, (cfg.vocab_size, cfg.d_model), init="normal",
                           dtype=param_dtype(cfg))}


def embed(p, tokens, cfg: ModelConfig):
    """Row lookup in the f32 table, scaled by sqrt(d) in f32, rounded once."""
    x = p["table"][tokens]
    return (x * math.sqrt(float(cfg.d_model))).to(compute_dtype(cfg))


def logits_f32(x, w):
    """x [..., d] @ w [d, V] (w cast to x's dtype) with f32 accumulation
    and f32 output (the reference's preferred_element_type=float32).
    Without autograd a bf16 product on the card accumulates in f32 inside
    one bf16 GEMM; torch.mm's out_dtype has no derivative, so a product
    that needs a gradient runs in f32 on the bf16-rounded operands (the
    same products, exact in f32, and the same f32 sums)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and not needs_grad:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


# ---------------------------------------------------------------------------
# attention (pre-norm residual: x + attn(norm(x)); MLP added by the caller)
# ---------------------------------------------------------------------------


def attn_params(gen, cfg: ModelConfig, serving: bool = False):
    """Self- and cross-attention params alike: a cross block's keys and
    values are projected from d_model inputs (the VLM's vision features
    are projected upstream), as in the reference."""
    d, Hq, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = weight_dtype(cfg, serving)
    return {
        "wq": param(gen, (d, Hq, D), dtype=dt, fan_in=d),
        "wk": param(gen, (d, Hkv, D), dtype=dt, fan_in=d),
        "wv": param(gen, (d, Hkv, D), dtype=dt, fan_in=d),
        "wo": param(gen, (Hq, D, d), dtype=dt, fan_in=Hq * D),
        "norm": rmsnorm_params(gen, d),
    }


def _proj(x, w):
    """x [..., S, d] @ w [d, H, D] -> [..., S, H, D]."""
    d, H, D = w.shape
    return (x @ w.reshape(d, H * D).to(x.dtype)).reshape(*x.shape[:-1], H, D)


def _project_qkv(p, x, cfg: ModelConfig, positions, kv_src=None):
    """q from x, k and v from kv_src (cross attention: no rope on either,
    as the reference) or from x (rope on q and k at `positions`)."""
    if kv_src is not None:
        return _proj(x, p["wq"]), _proj(kv_src, p["wk"]), _proj(kv_src, p["wv"])
    q = rope(_proj(x, p["wq"]), positions, cfg.rope_theta)
    k = rope(_proj(x, p["wk"]), positions, cfg.rope_theta)
    v = _proj(x, p["wv"])
    return q, k, v


def _out_proj(out, wo):
    """out [..., S, H, D] @ wo [H, D, d] -> [..., S, d]."""
    H, D, d = wo.shape
    return out.reshape(*out.shape[:-2], H * D) @ wo.reshape(H * D, d).to(out.dtype)


def attn_forward(p, x, cfg: ModelConfig, *, window: int = 0, kv_src=None,
                 causal: bool = True):
    """Training path over x [B,S,d]: causal self-attention (+ sliding
    window), non-causal self-attention (causal=False), or cross attention
    to kv_src [B,Sk,d] (no mask, no rope). Returns the attention output
    [B,S,d] (residual added by the caller). Always through the
    flash-attention wrapper (K2): the CUDA kernel on CUDA tensors,
    mha_reference on CPU tensors. The reference reaches its kernel only for
    causal self-attention under cfg.use_flash_kernel (off by default) and
    sends the other calls to mha_reference; the port does not read the
    flag, so that the kernel is the path (all compute one function: the
    kernel masks keys at j >= Sk). Under attn_impl="chunked" the kernel is
    the path on the card all the same, and CPU tensors run self-attention
    through `mha_chunked` (cross attention through `mha_reference`), as
    the reference does."""
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    cross = kv_src is not None
    S = x.shape[-2]
    q, k, v = _project_qkv(p, h, cfg, torch.arange(S, device=x.device), kv_src)
    out = flash_attention(q, k, v, causal=causal and not cross, window=window,
                          cross=cross, chunk=0 if cross else _attn_chunk(cfg))
    return _out_proj(out, p["wo"])


def _attn_chunk(cfg: ModelConfig) -> int:
    """cfg.attn_chunk under attn_impl="chunked", else 0 (the reference
    takes any other value as "ref")."""
    return cfg.attn_chunk if cfg.attn_impl == "chunked" else 0


def _ring(cfg: ModelConfig, window: int, cap: int) -> bool:
    """Whether a cache of capacity `cap` for a layer of `window` is a ring
    of `window` slots (cfg.decode_long_window: position p lives at slot
    p % window), as the reference decides at init and prefill."""
    return bool(window) and bool(cfg.decode_long_window) and cap > window


def attn_prefill(p, x, cfg: ModelConfig, *, window: int = 0, max_len: int = 0):
    """x: [B,S,d]. Returns (y [B,S,d], cache {'k','v'} [B,cap,Hkv,D]) with
    the prompt's K/V in rows 0..S-1 and zeros up to cap = max_len or S.
    Under cfg.decode_long_window a windowed layer whose cap exceeds the
    window gets a ring of `window` slots instead: position p at slot
    p % window, so for S >= window the last `window` keys rolled by
    S % window, for S < window the prompt's keys zero-padded.

    Under attn_impl="ref" the attention is the plain `mha_reference` on
    every device, as in the reference (its prefill never reaches its
    kernel either): only the sequential engine prefills, and it is the
    continuous engine's f32 parity oracle, whose extend runs
    `mha_reference` too. Under attn_impl="chunked" it is the online
    softmax without the S x S scores: K2 on the card (causal, the layer's
    window), `mha_chunked` over cfg.attn_chunk keys on CPU tensors, as the
    reference's `mha_chunked`. The sequential engine's prefill and the
    continuous engine's extend then compute the same function but round
    apart, as they do in the reference."""
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    S = x.shape[-2]
    q, k, v = _project_qkv(p, h, cfg, torch.arange(S, device=x.device))
    chunk = _attn_chunk(cfg)
    if chunk:
        out = flash_attention(q, k, v, causal=True, window=window, chunk=chunk)
    else:
        out = mha_reference(q, k, v, causal=True, window=window)
    y = _out_proj(out, p["wo"])
    cap = max_len or S
    if _ring(cfg, window, cap) and S >= window:
        shift = S % window
        return y, {"k": torch.roll(k[:, -window:], shift, dims=1),
                   "v": torch.roll(v[:, -window:], shift, dims=1)}
    pad = (window if _ring(cfg, window, cap) else cap) - S
    return y, {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
               "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


def _write_rows(c, rows, idx, new, write):
    """c[rows, idx] = new, in place; rows where `write` is False keep their
    old entry (the reference's where-masked cache update)."""
    new = new.to(c.dtype)
    if write is not None:
        new = torch.where(write[:, None, None], new, c[rows, idx])
    c[rows, idx] = new


def attn_decode(p, x_t, cache, pos, cfg: ModelConfig, *, window: int = 0,
                write: Optional[torch.Tensor] = None, kv_src=None):
    """One-token decode. x_t: [B,1,d]; pos: int or per-row [B] positions
    (slot-based continuous batching: each row sits at its own depth in its
    own cache slot). cache: {'k','v'} [B,cap,Hkv,D], updated in place at
    row b's slot for pos[b] where write[b] (all rows when write is None).
    Returns y [B,1,d].

    The cache is a ring iff window and cap == window, as the reference
    decides (without reading cfg.decode_long_window): position p at slot
    p % cap, and the query sees the min(p + 1, cap) live slots, no window.
    Otherwise slot p, the first p + 1 slots, the window from p.

    With kv_src [B,Sk,d]: cross attention of the one query to kv_src's
    keys and values (no rope, no cache, every key visible; cache, pos,
    window and write are not read). The reference runs `mha_reference`
    here; the port runs the same function through the flash-decode
    wrapper with kv_valid = Sk. Every call goes through the flash-decode
    wrapper (K4: the CUDA kernel on CUDA tensors), counted by mode."""
    attn_decode.calls += 1
    h = rmsnorm(p["norm"], x_t, cfg.norm_eps)
    B = x_t.shape[0]
    if kv_src is not None:
        q, k, v = _project_qkv(p, h, cfg, None, kv_src)
        out = flash_decode(q, k, v, kv_valid=k.shape[1], mode="cross")
        return _out_proj(out, p["wo"])
    pos_rows = per_row(pos, B, x_t.device)
    q, k, v = _project_qkv(p, h, cfg, pos_rows[:, None])
    cap = cache["k"].shape[1]
    rows = torch.arange(B, device=x_t.device)
    ring = bool(window) and cap == window
    # a frozen row may sit at pos == cap; its (masked) write is clamped
    idx = pos_rows.long() % cap if ring else pos_rows.long().clamp(max=cap - 1)
    _write_rows(cache["k"], rows, idx, k[:, 0], write)
    _write_rows(cache["v"], rows, idx, v[:, 0], write)
    if ring:
        out = flash_decode(q, cache["k"], cache["v"],
                           kv_valid=torch.clamp(pos_rows + 1, max=cap),
                           mode="ring")
    else:
        out = flash_decode(q, cache["k"], cache["v"], kv_valid=pos_rows + 1,
                           q_offset=pos_rows, window=window)
    return _out_proj(out, p["wo"])


# decode-attention calls, counted where the engines make them; on CUDA
# every one must be a flash-decode kernel launch
register(attn_decode, "calls")


def attn_extend(p, x_c, cache, start, cfg: ModelConfig, *, window: int = 0):
    """Chunked-prefill continuation: append a chunk of C tokens per row to
    a partially filled cache, in place. x_c: [B,C,d]; start: int or [B]
    tokens already cached per row (start + C <= cap). Rows past a
    request's real prompt length ride along as padding: their K/V land
    above every real query's causal horizon and are overwritten by later
    writes at the true positions. Ring caches are refused, as in the
    reference. Returns y [B,C,d].

    The attention is the plain `mha_reference` on every device: queries at
    an offset against a partly filled cache, a function no TPU kernel
    computes (the reference runs `mha_reference` here too)."""
    if window and cache["k"].shape[1] == window and cfg.decode_long_window:
        raise ValueError("attn_extend does not support ring KV caches "
                         "(decode_long_window); use full-capacity caches")
    h = rmsnorm(p["norm"], x_c, cfg.norm_eps)
    B, C, _ = x_c.shape
    start_rows = per_row(start, B, x_c.device).long()
    positions = start_rows[:, None] + torch.arange(C, device=x_c.device)[None, :]
    q, k, v = _project_qkv(p, h, cfg, positions)
    rows = torch.arange(B, device=x_c.device)[:, None]
    cache["k"][rows, positions] = k.to(cache["k"].dtype)
    cache["v"][rows, positions] = v.to(cache["v"].dtype)
    out = mha_reference(q, cache["k"], cache["v"], causal=True, window=window,
                        q_offset=start_rows, kv_valid=start_rows + C)
    return _out_proj(out, p["wo"])


def init_attn_cache(cfg: ModelConfig, batch: int, cap: int, device,
                    window: int = 0):
    """Zero K/V buffers [batch, cap, Hkv, D] in cfg.dtype; a ring of
    `window` slots where `_ring` says so."""
    if _ring(cfg, window, cap):
        cap = window
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    dt = compute_dtype(cfg)
    # two buffers: caches are written in place
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_params(gen, cfg: ModelConfig, d_ff: Optional[int] = None,
               serving: bool = False):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = weight_dtype(cfg, serving)
    return {
        "wg": param(gen, (d, f), dtype=dt),
        "wu": param(gen, (d, f), dtype=dt),
        "wd": param(gen, (f, d), dtype=dt),
        "norm": rmsnorm_params(gen, d),
    }


def mlp_forward(p, x, cfg: ModelConfig):
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    cdt = h.dtype
    g = h @ p["wg"].to(cdt)
    u = h @ p["wu"].to(cdt)
    return (F.silu(g) * u) @ p["wd"].to(cdt)
