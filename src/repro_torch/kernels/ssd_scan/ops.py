"""Public wrapper of the Mamba2 SSD-scan kernel (`csrc/ssd_scan.cu`, K3).

    y, state = ssd_scan(x, dt, A, Bm, Cm, chunk, initial_state=None)

x [B, L, H, P], dt [B, L, H] f32, A [H] f32, Bm / Cm [B, L, N], with L a
multiple of `chunk` (the reference's contract; mamba_forward pads to it).
Returns y [B, L, H, P] in x's dtype and the final state [B, H, P, N] f32.
It is an autograd Function: the forward launches the kernel on CUDA
tensors (or raises on one it cannot take), a nonzero `initial_state`
included (the reference wrapper sends that case to its oracle), and runs
the plain version (`ref.ssd_reference`) on CPU tensors; the backward
recomputes through the plain version and differentiates it, as the
reference's custom_vjp does (`ops.py:30-38`). On meta tensors (the
dry-run, `launch/dryrun.py`) the forward allocates its outputs and the
tensor-core path's ring there and adds the call and its cost
(`scan_cost`) to `kernels.counts.META`, by the path `scan_plan` picks.

The kernel has two hand-written paths, and `scan_plan` picks one from the
shapes and the dtype: bf16 with P and N multiples of 16 takes the
chunk-parallel tensor-core path (every main path), everything else the
FMA path (f32, which must stay exact to 2e-5, and bf16 with P or N such
as 8).

The forward can be captured in a CUDA graph (the continuous engine's
extend step, `serve/graphs.py`), as flash_decode's wrapper can: no device
value is read on the host, the outputs and the ring come from
`torch.empty` (the graph's pool under capture), the ticket table exists
before the capture, and every launch counts itself on the card, by path,
in `ssd_scan.counts` (`kernels/counts.py`).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.counts import META, DeviceCounts, KernelCost
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_reference

_KERNELS = Path(__file__).resolve().parents[1]
SOURCES = (_KERNELS / "ssd_scan" / "csrc" / "ssd_scan.cu",)
HEADERS = (_KERNELS / "common" / "csrc" / "hopper.cuh",)
MAX_DIM = 128  # kMaxPN in the source: P and N up to this
TC_CHUNK = 128  # kTc in the source: positions per block of the tensor-core path
FMA_TILE = 64  # kT in the source: positions per step of the FMA path
SMEM_LIMIT = 232448  # shared memory one block may use on an H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# per (device, stream): the tensor-core path's int32 tickets and flags, two
# per (batch row, head group); zeroed once, and every launch leaves them at
# zero
_COUNTERS = {}
# tables that a larger one replaced: a CUDA graph captured on that stream
# may still launch the kernel on them, so they are never freed
_RETIRED = []


def scan_plan(B: int, L: int, H: int, P: int, N: int, dtype) -> dict:
    """The launch of [B, L, H, P] inputs with state size N in `dtype`: the
    path ("tc" or "fma"), positions per block T, heads per block G, the
    grid, the dynamic shared memory in bytes (the source's TcCfg::kSmem,
    or smem_floats * 4 for the FMA path), and the tensor-core path's
    scratch: the chunk chain's f32 ring of states and its int32 counters. The tensor-core path takes G, the
    largest of 4, 2, 1 that divides H and keeps the S_c accumulators within
    64 registers a thread (G * ceil(P / 64) * ceil(N / 64) <= 4). Raises on
    what neither path takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: no kernel for dtype {dtype}")
    if min(B, L, H, P, N) < 1:
        raise ValueError(f"ssd_scan: empty shape B={B} L={L} H={H} P={P} N={N}")
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"ssd_scan: kernel takes P, N <= {MAX_DIM}; got "
                         f"P={P}, N={N}")
    if dtype == torch.bfloat16 and P % 16 == 0 and N % 16 == 0:
        pb, nb = -(-P // 64), -(-N // 64)
        G = next(g for g in (4, 2, 1) if H % g == 0 and g * pb * nb <= 4)
        T = TC_CHUNK
        chunks = -(-L // T)
        smem = (2 * T * nb * 64 * 2          # C and B tiles
                + G * T * pb * 64 * 2        # x tiles
                + 2 * G * pb * nb * 64 * 64 * 2  # h_in's high and low halves
                + 4 * G * T * 4              # dt, cs, w, exp(cs) per head
                + 24 + 8 * (1 + G) + 1024)   # exp(cs_T), ticket, barriers, slack
        return {"path": "tc", "T": T, "G": G, "chunks": chunks,
                "grid": (B * (H // G) * chunks,), "smem_bytes": smem,
                "ring": (B, H, 2, pb * nb * 64 * 64),
                "counters": (2 * B * (H // G),)}
    T = FMA_TILE
    smem = 4 * (2 * T * (N + 1) + T * (P + 1) + T * (T + 1) + P * (N + 1) + 3 * T)
    return {"path": "fma", "T": T, "G": 1, "chunks": -(-L // T), "grid": (H, B),
            "smem_bytes": smem, "ring": None, "counters": None}


def scan_cost(B: int, L: int, H: int, P: int, N: int, chunk: int, dtype,
              with_state: bool) -> KernelCost:
    """One forward call's cost: x and y [B, L, H, P] and Bm, Cm [B, L, N] in
    `dtype`, dt [B, L, H] and A [H] in f32, the final state [B, H, P, N]
    f32 (and the initial one when given) each moved once; the chunked
    scan's products per chunk of `chunk` positions. Workspace: the
    tensor-core path's f32 ring (`scan_plan`)."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * L * H * P + 2 * B * L * N) * elt + 4 * (B * L * H + H) \
        + 4 * B * H * P * N * (2 if with_state else 1)
    flops = B * H * 2 * L * (chunk * N + chunk * P // 2 + 2 * P * N)
    ring = scan_plan(B, L, H, P, N, dtype)["ring"]
    work = 0 if ring is None else 4 * ring[0] * ring[1] * ring[2] * ring[3]
    return KernelCost(flops=flops, bytes=nbytes, workspace_bytes=work)


def _meta_call(x, Bm, chunk: int, h0):
    """The dry-run's call on meta tensors: y, the final state and the
    ring, and the call in META by its path."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    plan = scan_plan(B, L, H, P, N, x.dtype)
    META.add("ssd_scan", scan_cost(B, L, H, P, N, chunk, x.dtype, h0 is not None),
             plan["path"])
    if plan["ring"] is not None:
        torch.empty(plan["ring"], dtype=torch.float32, device=x.device)
    return (torch.empty_like(x),
            torch.empty((B, H, P, N), dtype=torch.float32, device=x.device))


def _counters(device, stream, n: int) -> torch.Tensor:
    """The stream's ticket table of at least n entries, made outside any
    CUDA graph capture and never freed once replaced, as in
    `flash_decode.ops._counters` (a graph launches on the address it
    captured; every launch leaves the table at zero)."""
    key = (device, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "ssd_scan: no ticket table of this size for the capturing "
                "stream; run the step once on that stream before capture")
        if c is not None:
            _RETIRED.append(c)
        c = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return c


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_cuda_library("ssd_scan", SOURCES, HEADERS)
    fn = lib.repro_ssd_scan
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P, P]
    fn.restype = I
    lib.repro_ssd_scan_error_string.argtypes = [I]
    lib.repro_ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, Bm, Cm, h0):
    ts = [x, dt, A, Bm, Cm] + ([] if h0 is None else [h0])
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("ssd_scan: x is on CUDA, so every input must be on "
                         "the same card")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x/Bm/Cm must share a dtype among "
                         f"float32/bfloat16, got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or (
            h0 is not None and h0.dtype != torch.float32):
        raise ValueError("ssd_scan: dt, A and initial_state must be float32")
    if x.ndim != 4:
        raise ValueError(f"ssd_scan: want x [B,L,H,P], got {tuple(x.shape)}")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, L, H) or A.shape != (H,) or Bm.shape != (B, L, N)
            or Cm.shape != (B, L, N)
            or (h0 is not None and h0.shape != (B, H, P, N))):
        raise ValueError(f"ssd_scan: mismatched shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    plan = scan_plan(B, L, H, P, N, x.dtype)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if plan["path"] == "tc" and any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan: the tensor-core path loads x, Bm and Cm "
                         "with TMA, which needs 16-byte aligned bases")
    return plan


def _launch(x, dt, A, Bm, Cm, h0):
    plan = _check(x, dt, A, Bm, Cm, h0)
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tc = plan["path"] == "tc"
    ring = counters = None
    if tc:  # the chunk chain's hand-off states and its tickets and flags
        ring = torch.empty(plan["ring"], dtype=torch.float32, device=x.device)
        counters = _counters(x.device, stream, plan["counters"][0])
    lib = _lib()
    rc = lib.repro_ssd_scan(
        _DTYPES[x.dtype], int(tc), plan["G"], x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if ring is None else ring.data_ptr(),
        None if counters is None else counters.data_ptr(), B, L, H, P, N,
        ssd_scan.counts.entry(x.device, plan["path"]), stream)
    if rc != 0:
        msg = lib.repro_ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} ({rc})")
    return y, state


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, initial_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused output's grad is None
        if x.is_meta:
            return _meta_call(x, Bm, chunk, initial_state)
        if x.is_cuda:
            return _launch(x, dt, A, Bm, Cm, initial_state)
        return ssd_reference(x, dt, A, Bm, Cm, chunk=chunk,
                             initial_state=initial_state)

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(
                t.is_floating_point()) for t in saved]
            y, state = ssd_chunked(*ins[:5], chunk=ctx.chunk,
                                   initial_state=ins[5])
            pairs = [(o, g) for o, g in ((y, gy), (state, gstate))
                     if g is not None]
            wrt = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(wrt))
        return (*(None if t is None else next(grads) for t in ins[:5]), None,
                None if ins[5] is None else next(grads))


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None):
    """The SSD scan (see the module docstring): (y, final_state)."""
    if x.shape[1] % chunk:
        raise ValueError(f"ssd_scan: L={x.shape[1]} is not a multiple of "
                         f"chunk={chunk}")
    return _SSDScan.apply(x, dt, A, Bm, Cm, int(chunk), initial_state)


# kernel launches by path ("fma", "tc"), counted on the card by each launch
# (the plain CPU path is not counted): a run reads them to show that its
# Mamba2 layers went through the kernel, and which of them took the
# tensor-core path
ssd_scan.counts = DeviceCounts("ssd_scan", ("fma", "tc"))
