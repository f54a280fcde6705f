"""Learning-rate schedules (port of `repro.optim.schedules`): each one
returns fn(step) -> a 0-d float32 tensor, the reference's jnp formulas in
torch."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(value: float):
    return lambda step: _f32(value)


def cosine(peak: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def inverse_sqrt(peak: float, warmup_steps: int = 100):
    def fn(step):
        step = _f32(step) + 1.0
        return peak * torch.minimum(step / warmup_steps,
                                    torch.sqrt(warmup_steps / step))

    return fn
