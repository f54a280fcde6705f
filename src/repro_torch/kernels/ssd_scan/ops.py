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
reference's custom_vjp does (`ops.py:30-38`).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_reference

SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",)
MAX_DIM = 128  # kMaxPN in the source: P and N up to this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_cuda_library("ssd_scan", SOURCES)
    fn = lib.repro_ssd_scan
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
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
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"ssd_scan: kernel takes P, N <= {MAX_DIM}; got "
                         f"P={P}, N={N}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan: inputs must be contiguous")


def _launch(x, dt, A, Bm, Cm, h0):
    _check(x, dt, A, Bm, Cm, h0)
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.repro_ssd_scan(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, L, H, P, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.repro_ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} ({rc})")
    ssd_scan.launches += 1
    return y, state


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, initial_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused output's grad is None
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


# kernel launches (the plain CPU path is not counted): a run reads it to
# show that its Mamba2 layers went through the kernel
ssd_scan.launches = 0
