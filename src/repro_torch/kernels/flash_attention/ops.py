"""Public wrapper of the flash-attention kernel (`csrc/flash_attention.cu`,
K2): every attention of the training forward. Causal / sliding-window
self-attention, non-causal self-attention (encoder blocks) and cross
attention (keys from another sequence, no mask but their end) are one
function to the kernel, which masks key j of row i iff j >= Sk or, when causal, j > i or,
with a window, i - j >= window.

Model code calls flash_attention(q, k, v, causal, window) in the model's
`[B, S, H, D]` layout, as in the reference's
`repro.kernels.flash_attention.ops`. It is an autograd Function: the
forward launches the kernel on CUDA tensors (or raises on one it cannot
take) and runs the plain version (`ref.mha_reference`) on CPU tensors;
the backward recomputes through the plain version and differentiates it,
as the reference's custom_vjp does (`ops.py:41-45`). The kernel reads q,
k and v through their strides, so unlike the reference wrapper nothing is
transposed. On meta tensors (the dry-run, `launch/dryrun.py`) the forward
allocates its output there and adds the call and its cost
(`attention_cost`) to `kernels.counts.META`; the backward recomputes
through the plain version on meta, as it does on the card.

Launch counters: `flash_attention.launches` counts every launch;
`.launches_cross` the ones the caller made as cross attention
(`cross=True`) and `.launches_bidir` the other non-causal ones (the
causal ones are the rest).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.counts import META, KernelCost, register
from repro_torch.kernels.flash_attention.ref import mha_chunked, mha_grouped, mha_reference

_KERNELS = Path(__file__).resolve().parents[1]
SOURCES = (_KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",)
HEADERS = (_KERNELS / "common" / "csrc" / "hopper.cuh",)
MAX_HEAD_DIM = 256  # kMaxD in the source; D must also be a multiple of 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tile_config(D: int) -> tuple:
    """(DP, BK) of the bf16 kernel for head dim D: D padded to whole
    64-column (128-byte) blocks, and the key rows per tile: 128 up to
    DP = 128 (zamba2's D = 112, whisper-tiny's D = 64), 64 above, where
    O's registers (DP / 2 per thread) leave room for a 64-key score tile
    only; at DP = 64 the 128-key tile is the faster (with the
    straight-line S product, whisper-tiny's encoder shape went from 0.1519
    to 0.1298 ms on an H100, chip_smoke.py's k2 phase). The source
    instantiates exactly these pairs (launch_tc)."""
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: no tiles for D={D}")
    dp = -(-D // 64) * 64
    return dp, (128 if dp <= 128 else 64)


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, per head: all Sq x Sk
    without the causal mask (the paths' non-causal calls have no window),
    else those of a causal (+ window) mask over Sq = Sk."""
    if not causal:
        return Sq * Sk
    S = Sq
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_cost(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
                   causal: bool, window: int, itemsize: int) -> KernelCost:
    """One forward call's cost: q and the output [B, Sq, Hq, D], k and v
    [B, Sk, Hkv, D] each moved once; two products of 2 D operations for
    every visible (query, key) pair of every query head. No workspace."""
    return KernelCost(
        flops=4 * D * Hq * B * visible_pairs(Sq, Sk, causal, window),
        bytes=2 * (B * Sq * Hq * D + B * Sk * Hkv * D) * itemsize)


def _meta_call(q, k, causal: bool, window: int, cross: bool) -> torch.Tensor:
    """The dry-run's call on meta tensors: the output, and the call in
    META by the mode the counters on the card keep."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    META.add("flash_attention", attention_cost(B, Sq, Sk, Hq, Hkv, D, causal,
                                               window, q.element_size()),
             "cross" if cross else "causal" if causal else "bidir")
    return torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_cuda_library("flash_attention", SOURCES, HEADERS)
    fn = lib.repro_flash_attention
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, P, I, I, I, I, I, I, I, I, P, I, I, P]
    fn.restype = I
    lib.repro_flash_attention_error_string.argtypes = [I]
    lib.repro_flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window):
    if not (k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q is on CUDA, so k and v must be "
                         "on the same card")
    check_layout(q, k, v, window)


def check_layout(q, k, v, window):
    """Raise on what the kernel does not take: dtypes, shapes, head dims,
    strides and alignment (the TMA maps need 16-byte aligned rows). Reads
    only metadata, so it runs on tensors anywhere."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v must share a dtype among "
                         f"float32/bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q [B,Sq,Hq,D], k = v "
                         f"[B,Sk,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention: mismatched shapes {tuple(q.shape)} "
                         f"vs {tuple(k.shape)}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"flash_attention: kernel takes D a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}; got D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # rows are loaded 16 bytes at a time (f32) or by TMA (bf16)
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs unit stride over "
                             f"D, other strides multiples of 8 elements and a "
                             f"16-byte aligned base; got {t.stride()}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")


def _launch(q, k, v, causal: bool, window: int, cross: bool) -> torch.Tensor:
    _check(q, k, v, window)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    dp, bk = tile_config(D)
    lib = _lib()
    rc = lib.repro_flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal), window,
        ctypes.cast(strides, ctypes.c_void_p), dp, bk,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.repro_flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({rc})")
    flash_attention.launches += 1
    if cross:
        flash_attention.launches_cross += 1
    elif not causal:
        flash_attention.launches_bidir += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, cross):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.is_meta:
            return _meta_call(q, k, causal, window, cross)
        if q.is_cuda:
            return _launch(q, k, v, causal, window, cross)
        return mha_reference(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = mha_grouped(*qkv, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    cross: bool = False, chunk: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, D], k / v [B, Sk, Hkv, D] -> [B, Sq, Hq, D] in q's
    dtype: softmax(q k^T / sqrt(D)) v with the causal and window masks and
    GQA (kv head h // (Hq / Hkv)). On CUDA a row with no visible key gives
    0, as the TPU kernel does; the plain version averages over the masked
    keys (the training forward never has such a row). `cross` says that k
    and v come from another sequence: the launch counts as cross attention,
    which takes no causal mask. `chunk` > 0 (cfg.attn_chunk under
    cfg.attn_impl = "chunked") makes the plain version of CPU tensors
    `ref.mha_chunked` over KV chunks of that many keys, differentiated
    through its own per-chunk recomputation; on the card and on meta
    tensors it changes nothing (K2 is the online softmax over key
    tiles)."""
    if cross and causal:
        raise ValueError("flash_attention: cross attention takes no causal mask")
    if chunk and not (q.is_cuda or q.is_meta):
        return mha_chunked(q, k, v, causal=causal, window=window, chunk=chunk)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window), bool(cross))


# kernel launches (the plain CPU path is not counted): a run reads them to
# show that its attention went through the kernel, and in which mode
register(flash_attention, "launches", "launches_bidir", "launches_cross")
