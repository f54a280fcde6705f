"""Plain-torch Mamba2 SSD (state-space duality) oracle, chunked algorithm:
the port of `repro.kernels.ssd_scan.ref.ssd_reference` (lines 41-105).

Per head h with scalar decay A_h (negative), inputs x_t and data-dependent
B_t, C_t (shared across heads, n_groups = 1):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T        (state [P, N])
    y_t = C_t^T h_t

through the chunked SSD decomposition: an intra-chunk (attention-like)
term plus an inter-chunk recurrence on the chunk states. It is the plain
version of the SSD-scan kernel (K3, `csrc/ssd_scan.cu`), the path of CPU
tensors, and the function that the kernel's backward differentiates.

Shapes: x [B, L, H, P], dt [B, L, H] (softplus-activated), A [H],
Bm / Cm [B, L, N]; returns y [B, L, H, P] in x's dtype and the final state
[B, H, P, N] in f32.

`ssd_decode_step` is the one-token recurrence of serving (the port of the
reference's `ssd_decode_step`, lines 108-122). No TPU kernel computes it,
so this plain version is its only form: elementwise work and two small
products per row.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.counts import register


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """S[..., i, j] = sum_{k=j+1..i} a[..., k] on and below the diagonal,
    -inf above it (so exp() = 0)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    S = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return S.masked_fill(~mask, float("-inf"))


def ssd_reference(x, dt, A, Bm, Cm, *, chunk: int = 128,
                  initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD as the plain version of the kernel: `ssd_chunked`, with
    its calls on CUDA tensors counted."""
    if x.is_cuda:
        ssd_reference.cuda_calls += 1
    return ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                       initial_state=initial_state)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
):
    """Chunked SSD. Returns (y [B,L,H,P], final_state [B,H,P,N] f32). The
    kernel's backward differentiates this function (uncounted)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    C = L // chunk

    f32 = torch.float32
    x_ = x.to(f32).reshape(Bsz, C, chunk, H, P)
    dt_ = dt.to(f32).reshape(Bsz, C, chunk, H)
    B_ = Bm.to(f32).reshape(Bsz, C, chunk, N)
    C_ = Cm.to(f32).reshape(Bsz, C, chunk, N)
    dA = dt_ * A.to(f32)[None, None, None, :]  # [B,C,T,H]
    dA = torch.movedim(dA, -1, 2)  # [B,C,H,T]

    # intra-chunk (diagonal) term: attention-like, lower-triangular
    Lmat = torch.exp(_segsum(dA))  # [B,C,H,T,T]
    CB = torch.einsum("bctn,bcsn->bcts", C_, B_)  # [B,C,T,T]
    W = CB[:, :, None] * Lmat * torch.movedim(dt_, -1, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchts,bcshp->bcthp", W, x_)

    # chunk states: state_c = sum_s decay(T-1..s) * dt_s * B_s x_s^T
    cum = torch.cumsum(dA, dim=-1)
    decay_states = torch.exp(cum[..., -1:] - cum)  # [B,C,H,T]
    states = torch.einsum("bcht,bctn,bcthp->bchpn", decay_states, B_,
                          x_ * dt_[..., None])

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(torch.sum(dA, dim=-1))  # [B,C,H]
    h = (initial_state.to(f32) if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device))
    entering = []
    for c in range(C):
        entering.append(h)  # the state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # [B,C,H,P,N]

    # inter-chunk output: y_off[t] = C_t . (decay(0..t) * h_entering)
    state_decay = torch.exp(cum)  # [B,C,H,T]
    y_off = torch.einsum("bctn,bchpn,bcht->bcthp", C_, entering, state_decay)

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y.to(x.dtype), h


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One token of the recurrence, in f32: state [B, H, P, N] f32, x_t
    [B, H, P], dt_t [B, H] (softplus-activated), A [H], B_t / C_t [B, N].
    Returns (y_t [B, H, P] in x_t's dtype, new_state [B, H, P, N] f32)."""
    f32 = torch.float32
    dt = dt_t.to(f32)
    dA = torch.exp(dt * A.to(f32)[None, :])  # [B, H]
    upd = B_t.to(f32)[:, None, None, :] * (x_t.to(f32) * dt[..., None])[..., None]
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.to(f32))
    return y.to(x_t.dtype), new_state


# calls on CUDA tensors: on the card the model path must reach the kernel,
# never this plain version (its backward is counted separately)
register(ssd_reference, "cuda_calls")
