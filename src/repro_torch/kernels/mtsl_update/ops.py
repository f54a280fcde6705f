"""Public wrapper of the fused MTSL update kernel (`csrc/mtsl_update.cu`).

    mtsl_update_(p, g, eta)    # p <- p - eta * g, in place

`eta` is an f32 [R] tensor (or a float, R = 1): the leaf is viewed as
`[R, numel / R]` and row r steps by eta[r], so a stacked tower leaf
`[M, ...]` takes one step size per client. p must be contiguous and is
updated in its own storage, the port's analogue of the reference's buffer
donation. g may have any strides (a conv weight's gradient comes back
permuted from the HWIO <-> OIHW view): a strided g is copied to p's layout
first. CPU tensors go to the plain version in `ref.py`; CUDA tensors go to
the hand-written kernel, or the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.mtsl_update.ref import eta_rows, mtsl_update_reference

SOURCES = (Path(__file__).resolve().parent / "csrc" / "mtsl_update.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_cuda_library("mtsl_update", SOURCES)
    fn = lib.repro_mtsl_update
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, P, P, P, LL, LL, P]
    fn.restype = I
    lib.repro_mtsl_update_error_string.argtypes = [I]
    lib.repro_mtsl_update_error_string.restype = ctypes.c_char_p
    return lib


def _check(p, g, eta):
    if not (g.is_cuda and eta.is_cuda) or len({p.device, g.device, eta.device}) != 1:
        raise ValueError("mtsl_update_: p is on CUDA, so g and eta must be on "
                         "the same card")
    if p.dtype not in _DTYPES or g.dtype != p.dtype:
        raise ValueError(f"mtsl_update_: p and g must share a dtype among "
                         f"float32/bfloat16, got {p.dtype}/{g.dtype}")
    if g.shape != p.shape:
        raise ValueError(f"mtsl_update_: g {tuple(g.shape)} != p {tuple(p.shape)}")
    if not (p.is_contiguous() and g.is_contiguous()):
        raise ValueError("mtsl_update_: p must be contiguous")
    R = eta.numel()
    if eta.dtype != torch.float32 or eta.ndim != 1 or not eta.is_contiguous():
        raise ValueError(f"mtsl_update_: eta must be a contiguous f32 [R] "
                         f"tensor, got {eta.dtype} {tuple(eta.shape)}")
    if R < 1 or p.numel() % R:
        raise ValueError(f"mtsl_update_: {R} step sizes do not divide "
                         f"{p.numel()} elements into rows")


def mtsl_update_(p: torch.Tensor, g: torch.Tensor, eta) -> torch.Tensor:
    """p <- p - eta * g in place (see the module docstring); returns p."""
    if not p.is_cuda:
        with torch.no_grad():
            return p.copy_(mtsl_update_reference(p, g, eta))
    eta = eta_rows(eta, p.device)
    if g.shape == p.shape and not g.is_contiguous():
        g = g.contiguous()
    _check(p, g, eta)
    if p.numel() == 0:
        return p
    lib = _lib()
    rc = lib.repro_mtsl_update(
        _DTYPES[p.dtype], p.data_ptr(), g.data_ptr(), eta.data_ptr(),
        p.numel(), eta.numel(), torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        msg = lib.repro_mtsl_update_error_string(rc).decode()
        raise RuntimeError(f"mtsl_update kernel launch failed: {msg} ({rc})")
    mtsl_update_.launches += 1
    return p


# kernel launches (the plain CPU path is not counted): a run reads it to
# show that its parameter updates went through the kernel
mtsl_update_.launches = 0
