"""Public wrapper of the fused MTSL update kernel (`csrc/mtsl_update.cu`).

    mtsl_update_(p, g, eta)    # p <- p - eta * g, in place

`eta` is an f32 [R] tensor (or a float, R = 1): the leaf is viewed as
`[R, numel / R]` and row r steps by eta[r], so a stacked tower leaf
`[M, ...]` takes one step size per client. p must be contiguous and is
updated in its own storage, the port's analogue of the reference's buffer
donation. g may have any strides (a conv weight's gradient comes back
permuted from the HWIO <-> OIHW view): a strided g is copied to p's layout
first. CPU tensors go to the plain version in `ref.py`; CUDA tensors go to
the hand-written kernel, or the wrapper raises. Meta tensors (the
dry-run, `launch/dryrun.py`) launch nothing: the call and its cost
(`update_cost`) go to `kernels.counts.META`, and p stays as it is.

    mtsl_update_multi_(ps, gs, etas)   # every leaf, in one launch

does what `mtsl_update_(p, g, eta)` does for each (p, g, eta) of the
lists, bit for bit, in one launch. Both go through one kernel, which walks
a table of leaf descriptors (`leaf_table`; `mtsl_update_`'s has one row).
The host builds the table for each call (the gradients' storage changes
every round) in pinned memory from torch's own allocator and copies it to
the card on the current stream: the caching host allocator does not hand
that block out again before the copy has read it. The mtsl round's apply
step calls `mtsl_update_multi_` once per round.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.build import load_cuda_library
from repro_torch.kernels.counts import META, KernelCost, register
from repro_torch.kernels.mtsl_update.ref import eta_rows, mtsl_update_reference

SOURCES = (Path(__file__).resolve().parent / "csrc" / "mtsl_update.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PIECE = 8192  # kPiece in the source: elements per piece of a leaf
# columns of a leaf_table row (LeafDesc in the source)
TABLE_COLUMNS = ("p", "g", "eta", "n", "row_len", "piece0", "dtype", "vector")


def update_cost(numel: int, itemsize: int, leaves: int = 1) -> KernelCost:
    """One call's cost over `leaves` leaves of `numel` elements in all, of
    `itemsize` bytes: p and g read and p written once (3 * numel *
    itemsize bytes, the step sizes' few bytes left out), a multiply and a
    subtract an element, and the leaf table as workspace."""
    return KernelCost(flops=2 * numel, bytes=3 * numel * itemsize,
                      workspace_bytes=8 * len(TABLE_COLUMNS) * leaves)


def _meta_call(fn, ps) -> None:
    """The dry-run's record of one call on meta leaves (nothing runs)."""
    leaves = [p for p in ps if p.numel()]
    if not leaves:
        return
    cost = [update_cost(p.numel(), p.element_size()) for p in leaves]
    META.add(fn.__name__, KernelCost(sum(c.flops for c in cost),
                                     sum(c.bytes for c in cost),
                                     8 * len(TABLE_COLUMNS) * len(leaves)),
             leaves=len(leaves))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_cuda_library("mtsl_update", SOURCES)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_mtsl_update_multi.argtypes = [P, I, LL, P]
    lib.repro_mtsl_update_multi.restype = I
    lib.repro_mtsl_update_error_string.argtypes = [I]
    lib.repro_mtsl_update_error_string.restype = ctypes.c_char_p
    return lib


def leaf_table(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
               etas: Sequence[torch.Tensor]):
    """The multi-tensor launch's leaf descriptors: an int64 [leaves, 8]
    array with the columns TABLE_COLUMNS (p's, g's and eta's addresses,
    numel, row length numel / R, first piece, dtype code, and whether the
    16-byte vector path applies: both bases aligned and every row a whole
    number of vectors), one row per nonempty leaf, and the total count of
    pieces. Raises on what the kernel does not take (on metadata only, so
    it runs on tensors anywhere)."""
    rows, piece = [], 0
    for p, g, eta in zip(ps, gs, etas, strict=True):
        if p.dtype not in _DTYPES or g.dtype != p.dtype:
            raise ValueError(f"mtsl_update: p and g must share a dtype "
                             f"among float32/bfloat16, got {p.dtype}/{g.dtype}")
        if g.shape != p.shape or not (p.is_contiguous() and g.is_contiguous()):
            raise ValueError(f"mtsl_update: want contiguous p and g of "
                             f"one shape, got {tuple(p.shape)}, {tuple(g.shape)}")
        n, R = p.numel(), eta.numel()
        if (eta.dtype != torch.float32 or eta.ndim != 1 or R < 1 or n % R
                or not eta.is_contiguous()):
            raise ValueError(f"mtsl_update: {R} step sizes "
                             f"({eta.dtype}) do not divide {n} elements into rows")
        if n == 0:
            continue
        row_len, vec = n // R, 16 // p.element_size()
        vector = (p.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
                  and (R == 1 or row_len % vec == 0))
        rows.append((p.data_ptr(), g.data_ptr(), eta.data_ptr(), n, row_len,
                     piece, _DTYPES[p.dtype], int(vector)))
        piece += -(-n // PIECE)
    return np.array(rows, dtype=np.int64).reshape(-1, len(TABLE_COLUMNS)), piece


def _card_table(ps, gs, etas):
    """The leaf table of CUDA leaves on their card, and its count of pieces
    (0: nothing to launch). A strided g is copied to p's layout first."""
    dev = ps[0].device
    gs = [g.contiguous() if g.shape == p.shape and not g.is_contiguous() else g
          for p, g in zip(ps, gs, strict=True)]
    etas = [eta_rows(e, dev) for e in etas]
    if any(t.device != dev for t in (*ps, *gs, *etas)):
        raise ValueError("mtsl_update: every leaf, gradient and step size must "
                         "be on the same card")
    table, pieces = leaf_table(ps, gs, etas)
    if not pieces:
        return None, 0
    host = torch.empty(table.shape, dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = table
    return host.to(dev, non_blocking=True), pieces


def launch_table(table: torch.Tensor, pieces: int) -> None:
    """Launch the kernel on a leaf table already on the card (`leaf_table`'s
    rows as an int64 CUDA tensor), on the current stream. It counts
    nothing: the two wrappers count their own launches, and a timing of the
    kernel alone calls this with one table."""
    lib = _lib()
    rc = lib.repro_mtsl_update_multi(
        table.data_ptr(), table.shape[0], pieces,
        torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        msg = lib.repro_mtsl_update_error_string(rc).decode()
        raise RuntimeError(f"mtsl_update kernel launch failed: {msg} ({rc})")


def mtsl_update_multi_(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                       etas) -> Sequence[torch.Tensor]:
    """p <- p - eta * g in place for every (p, g, eta) of the lists, in one
    launch on CUDA tensors (see the module docstring); returns ps."""
    if not ps:
        return ps
    if ps[0].is_meta:
        _meta_call(mtsl_update_multi_, ps)
        return ps
    if not ps[0].is_cuda:
        with torch.no_grad():
            for p, g, eta in zip(ps, gs, etas, strict=True):
                p.copy_(mtsl_update_reference(p, g, eta))
        return ps
    table, pieces = _card_table(ps, gs, etas)
    if pieces:
        launch_table(table, pieces)
        mtsl_update_multi_.launches += 1
        mtsl_update_multi_.leaves += table.shape[0]
    return ps


def mtsl_update_(p: torch.Tensor, g: torch.Tensor, eta) -> torch.Tensor:
    """p <- p - eta * g in place (see the module docstring): one leaf, as a
    table of one row; returns p."""
    if p.is_meta:
        _meta_call(mtsl_update_, [p])
        return p
    if not p.is_cuda:
        with torch.no_grad():
            return p.copy_(mtsl_update_reference(p, g, eta))
    table, pieces = _card_table([p], [g], [eta])
    if pieces:
        launch_table(table, pieces)
        mtsl_update_.launches += 1
    return p


# single-leaf kernel launches (the plain CPU path is not counted)
register(mtsl_update_, "launches")
# multi-tensor launches, and the nonempty leaves they updated (the plain CPU
# path is not counted): a run reads both to show that every leaf of every
# round went through K1, one launch a round
register(mtsl_update_multi_, "launches", "leaves")
