"""Parameter creation: the reference's init kinds (`repro.nn.init`), drawn
from an explicit `torch.Generator`. A parameter lands on the generator's
device. The reference's logical-axis annotations and abstract mode serve
its mesh sharding and dry-run, which the port does not have yet.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def truncated_normal(gen: torch.Generator, shape, stddev: float, dtype):
    """Normal truncated at ±2σ, drawn in f32, cast, then scaled by σ."""
    x = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.to(dtype).mul_(stddev)


def param(
    gen: torch.Generator,
    shape: Sequence[int],
    init: str = "fan_in",
    dtype: torch.dtype = torch.float32,
    fan_in: Optional[int] = None,
) -> torch.Tensor:
    """Create one parameter. `fan_in` defaults to the second-to-last dim
    (matmul convention W[..., in, out])."""
    shape = tuple(int(s) for s in shape)
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if init == "normal":
        return truncated_normal(gen, shape, 0.02, dtype)
    if init == "fan_in":
        return truncated_normal(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=gen.device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=gen.device)
    raise ValueError(f"unknown init {init!r}")
