"""Seeded, slot-independent temperature sampling.

The reference draws with `jax.random` keys folded with the request id and
the position (`fold_in(key, pos)`), which torch cannot reproduce. The port
keeps that contract with a counter-based hash instead: the Gumbel noise of
vocabulary entry v for a row is a function of (key, position, v) alone, so
a request samples the same tokens whichever slot it lands in and whatever
else is batched with it. `argmax(logits / T + gumbel)` is a draw from
softmax(logits / T) (the Gumbel-max trick).

The hash is Wellons' 32-bit "lowbias32" mixer. Every helper works on
Python ints and on int64 tensors alike; products are split so that no
intermediate leaves 48 bits (int64 tensors must not overflow).
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32)."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & _MASK) << 16)) & _MASK


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold_in(key, data):
    """A new 32-bit key from `key` and a counter (int or int64 tensor)."""
    return _mix32((key & _MASK) ^ _mix32(data & _MASK))


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """[R, vocab] f32 standard Gumbel noise, entry (r, v) a function of
    (keys[r], v) only."""
    v = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    h = fold_in(keys.to(torch.int64)[:, None], v[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, temperature, keys: torch.Tensor) -> torch.Tensor:
    """Temperature sampling of logits [R, V] (f32) with per-row keys [R];
    temperature is a float or an [R] tensor. Returns int32 [R]."""
    if torch.is_tensor(temperature):
        temperature = temperature[:, None]
        temperature = torch.clamp(temperature, min=1e-6)
    else:
        temperature = max(float(temperature), 1e-6)
    z = logits / temperature + gumbel_noise(keys, logits.shape[-1])
    return torch.argmax(z, dim=-1).to(torch.int32)
