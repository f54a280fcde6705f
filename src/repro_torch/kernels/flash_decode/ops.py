"""Public wrapper of the flash-decode kernel (`csrc/flash_decode.cu`).

Model code calls flash_decode(q, k, v, kv_valid=...) in the cache layout
([B, 1, Hq, D] query, [B, cap, Hkv, D] cache), as in the reference's
`repro.kernels.flash_decode.ops`. CPU tensors go to the plain version in
`ref.py`; CUDA tensors go to the hand-written kernel, or the wrapper
raises. Meta tensors (the dry-run, `launch/dryrun.py`) get their output
and the bf16 path's partials there, and the call and its cost
(`decode_cost`, over a full cache: the dry-run decodes the last position
of its cache) go to `kernels.counts.META` by mode. The kernel reads the cache through its strides, so unlike the
reference wrapper nothing is transposed.

The bf16 kernel splits the cache into fixed runs of SPLIT_ROWS rows and
merges the splits in the same launch: the wrapper sizes its scratch from
the buffer's capacity (`split_plan`), never from kv_valid, so it never
waits on the card.

The wrapper can be captured in a CUDA graph (the serving engines' steps,
`serve/graphs.py`): it reads no device value on the host, its scratch
comes from `torch.empty` (the graph's private pool under capture, at an
address every replay reuses), and its counter table exists before the
capture (`_counters`). Every launch counts itself on the card, by mode, in
`flash_decode.counts` (`kernels/counts.py`): a launch replayed from a
graph is counted as an eager one is.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.counts import META, DeviceCounts, KernelCost
from repro_torch.kernels.flash_decode.ref import decode_reference, per_row

_KERNELS = Path(__file__).resolve().parents[1]
SOURCES = (_KERNELS / "flash_decode" / "csrc" / "flash_decode.cu",)
HEADERS = (_KERNELS / "common" / "csrc" / "hopper.cuh",)
GROUPS = (1, 2, 4, 8)  # query heads per kv head the source instantiates
MAX_HEAD_DIM = 256  # kMaxD in the source; D must also be a multiple of 8
SPLIT_ROWS = 64  # kSplit in the source: cache rows per split
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = ("self", "ring", "cross")  # the callers' uses, counted apart
# per (device, stream): the bf16 kernel's int32 counters, one per (row, kv
# head); zeroed once, and every launch leaves them at zero
_COUNTERS = {}
# tables that a larger one replaced: a CUDA graph captured on that stream
# may still launch the kernel on them, so they are never freed
_RETIRED = []


def split_plan(B: int, Hkv: int, cap: int, G: int, D: int) -> dict:
    """The bf16 kernel's grid and scratch for a [B, cap, Hkv, D] cache and
    G query heads per kv head: splits = ceil(cap / SPLIT_ROWS) fixed runs
    of rows; the f32 partials [B, Hkv, splits, G, D + 2] (acc over D, then
    m and l); and the counters [B * Hkv]."""
    splits = -(-cap // SPLIT_ROWS)
    return {"splits": splits, "partials": (B, Hkv, splits, G, D + 2),
            "counters": (B * Hkv,)}


def decode_cost(B: int, cap: int, Hq: int, Hkv: int, D: int, visible: int,
                dtype) -> KernelCost:
    """One call's cost over `visible` live (row, cache row) pairs in all:
    their keys and values, q and the output [B, 1, Hq, D] moved once, and
    kv_valid and q_offset (int32 [B]); two products of 2 D operations for
    every visible key of every query head. Workspace: the bf16 path's
    f32 partials (`split_plan`)."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * visible * Hkv * D + 2 * B * Hq * D) * elt + 2 * 4 * B
    work = 0
    if dtype == torch.bfloat16:
        b, h, s, g, d = split_plan(B, Hkv, cap, Hq // Hkv, D)["partials"]
        work = 4 * b * h * s * g * d
    return KernelCost(flops=4 * visible * Hq * D, bytes=nbytes, workspace_bytes=work)


def _meta_call(q, k, window: int, mode: str) -> torch.Tensor:
    """The dry-run's call on meta tensors, over a full cache (every row
    sees min(cap, window) keys): the output, the partials, and the call
    in META by mode."""
    B, _, Hq, D = q.shape
    cap, Hkv = k.shape[1], k.shape[2]
    visible = B * (min(cap, window) if window else cap)
    META.add("flash_decode", decode_cost(B, cap, Hq, Hkv, D, visible, q.dtype), mode)
    if q.dtype == torch.bfloat16:
        torch.empty(split_plan(B, Hkv, cap, Hq // Hkv, D)["partials"],
                    dtype=torch.float32, device=q.device)
    return torch.empty_like(q)


def _counters(device, stream, n: int) -> torch.Tensor:
    """The stream's counter table of at least n entries. A CUDA graph bakes
    the table's address into its launches, so a table is made outside any
    capture (the step's warm-up on the capture stream makes it,
    `serve/graphs.py`), and one that a larger table replaces is kept
    alive. Every launch leaves its entries at zero, so a replayed launch
    finds them as the captured one did."""
    key = (device, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_decode: no counter table of this size for the capturing "
                "stream; run the step once on that stream before capture")
        if c is not None:
            _RETIRED.append(c)
        c = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return c


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_cuda_library("flash_decode", SOURCES, HEADERS)
    fn = lib.repro_flash_decode
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, LL, LL, LL, P, P]
    fn.restype = I
    lib.repro_cuda_error_string.argtypes = [I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, kv_valid, q_offset, window):
    if not (k.is_cuda and v.is_cuda and kv_valid.is_cuda and q_offset.is_cuda):
        raise ValueError("flash_decode: q is on CUDA, so k, v, kv_valid and "
                         "q_offset must be too")
    if len({q.device, k.device, v.device, kv_valid.device, q_offset.device}) != 1:
        raise ValueError("flash_decode: tensors on different devices")
    check_layout(q, k, v, kv_valid, q_offset, window)


def check_layout(q, k, v, kv_valid, q_offset, window):
    """Raise on what the kernel does not take: dtypes, shapes, groups, head
    dims, strides and alignment (the bulk copies move 16-byte aligned rows
    of a multiple of 16 bytes). Reads only metadata, so it runs on tensors
    anywhere."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: q/k/v must share a dtype among "
                         f"float32/bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: want q [B,1,Hq,D], k = v "
                         f"[B,cap,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    Bk, cap, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv or cap < 1:
        raise ValueError(f"flash_decode: mismatched shapes {tuple(q.shape)} "
                         f"vs {tuple(k.shape)}")
    if Hq // Hkv not in GROUPS or D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"flash_decode: kernel takes G in {GROUPS} and D a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}; got "
                         f"G={Hq // Hkv}, D={D}")
    if not q.is_contiguous():
        raise ValueError("flash_decode: q must be contiguous")
    if k.stride(-1) != 1 or k.stride() != v.stride():
        raise ValueError(f"flash_decode: k and v need unit stride over D and "
                         f"equal strides; got {k.stride()}, {v.stride()}")
    # 16-byte loads (f32) and bulk copies (bf16) of whole rows
    if any(s % 8 for s in k.stride()[:3]) or any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode: q/k/v rows must be 16-byte aligned "
                         "(strides multiples of 8 elements)")
    for name, t in (("kv_valid", kv_valid), ("q_offset", q_offset)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous int32 "
                             f"[{B}], got {t.dtype} {tuple(t.shape)}")
    if window < 0:
        raise ValueError(f"flash_decode: window must be >= 0, got {window}")


def flash_decode(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k: torch.Tensor,  # [B, cap, Hkv, D]
    v: torch.Tensor,
    *,
    kv_valid,  # [B] or scalar: live cache rows per batch row
    q_offset=None,  # [B] or scalar absolute position (default kv_valid - 1)
    window: int = 0,
    mode: str = "self",
) -> torch.Tensor:
    """Single-query attention over a padded cache. Row b attends cache
    slots j with j < kv_valid[b] (and j > q_offset[b] - window when
    windowed). Returns [B, 1, Hq, D] in q's dtype.

    `mode` names the caller's use, for the launch counters only: "self"
    (a cache of the row's own keys at their positions), "ring" (a ring
    cache: kv_valid = min(pos + 1, cap), no window) or "cross" (keys of
    another sequence, kv_valid = their count). The kernel computes one
    function for all three."""
    if mode not in MODES:
        raise ValueError(f"flash_decode: mode must be one of {MODES}, got {mode!r}")
    if q.is_meta:
        return _meta_call(q, k, int(window), mode)
    if not q.is_cuda:
        return decode_reference(q, k, v, kv_valid=kv_valid, q_offset=q_offset,
                                window=window)
    B, _, Hq, D = q.shape
    kv_valid = per_row(kv_valid, B, q.device)
    q_offset = kv_valid - 1 if q_offset is None else per_row(q_offset, B, q.device)
    window = int(window)
    _check(q, k, v, kv_valid, q_offset, window)
    out = torch.empty_like(q)
    Hkv, cap = k.shape[2], k.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = counter = None
    splits = 0
    if q.dtype == torch.bfloat16:
        plan = split_plan(B, Hkv, cap, Hq // Hkv, D)
        splits = plan["splits"]
        part = torch.empty(plan["partials"], dtype=torch.float32, device=q.device)
        counter = _counters(q.device, stream, plan["counters"][0])
    lib = _lib()
    rc = lib.repro_flash_decode(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), kv_valid.data_ptr(), q_offset.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counter is None else counter.data_ptr(), splits,
        B, Hq, Hkv, D, cap, window,
        k.stride(0), k.stride(1), k.stride(2),
        flash_decode.counts.entry(q.device, mode), stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_decode kernel launch failed: {msg} ({rc})")
    return out


# kernel launches by mode, counted on the card by each launch (the plain CPU
# path is not counted): a run reads them to show that its decode attention
# went through the kernel, and in which mode
flash_decode.counts = DeviceCounts("flash_decode", MODES)
