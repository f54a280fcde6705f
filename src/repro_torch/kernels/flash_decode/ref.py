"""Plain PyTorch version of the flash-decode kernel: single-query attention
over a padded `[B, cap, Hkv, D]` cache with per-row `kv_valid`/`q_offset`.

It computes exactly what `csrc/flash_decode.cu` (and the reference's
Pallas `_decode_kernel`) computes: slot j is visible iff j < kv_valid[b]
and, when windowed, j > q_offset[b] - window; scores, softmax and the
value product in f32; masked probabilities exactly 0; output cast to q's
dtype. A row with no visible slot outputs zeros, as the kernels do (the
reference's `mha_reference` would average over the masked slots there;
serving never produces such a row, since kv_valid = pos + 1 >= 1).

The CPU tests use it, and `chip_smoke.py` holds the CUDA kernel against it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.counts import register

NEG_INF = -1e30


def per_row(x, batch: int, device) -> torch.Tensor:
    """An int or [B] tensor as an int32 [B] tensor on `device` (an int is
    filled on the device: no host->device copy)."""
    if not torch.is_tensor(x):
        return torch.full((batch,), int(x), dtype=torch.int32, device=device)
    if x.ndim == 0:
        return x.to(device=device, dtype=torch.int32).expand(batch).contiguous()
    return x.to(device=device, dtype=torch.int32)


def decode_reference(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k: torch.Tensor,  # [B, cap, Hkv, D]
    v: torch.Tensor,
    *,
    kv_valid,  # [B] or scalar: live cache rows per batch row
    q_offset=None,  # [B] or scalar absolute query position (default kv_valid-1)
    window: int = 0,
) -> torch.Tensor:
    if q.is_cuda:
        decode_reference.cuda_calls += 1
    B, _, Hq, D = q.shape
    cap, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_valid = per_row(kv_valid, B, q.device)
    q_offset = kv_valid - 1 if q_offset is None else per_row(q_offset, B, q.device)
    qf = q[:, 0].reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float()) * (1.0 / math.sqrt(D))
    kpos = torch.arange(cap, device=q.device)[None, :]
    mask = kpos < kv_valid[:, None].long()
    if window:
        mask = mask & (kpos > q_offset[:, None].long() - window)
    mask = mask[:, None, None, :]  # [B,1,1,cap]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float()) / denom
    return out.to(q.dtype).reshape(B, 1, Hq, D)


# calls made on CUDA tensors: the serving path must leave this at 0 (the
# wrapper sends CUDA tensors to the kernel); only kernel-vs-plain checks
# call the plain version on the card
register(decode_reference, "cuda_calls")
