"""Parameter creation: the reference's init kinds (`repro.nn.init`), drawn
from an explicit `torch.Generator`. A parameter lands on the generator's
device, or, inside `abstract_params()`, on the meta device: shapes and
dtypes without storage, the port's form of the reference's abstract mode
(parameter counts of full configs that do not fit in memory). The
reference's logical-axis annotations serve its mesh sharding, which the
port does not have yet.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch

_ABSTRACT = [False]


@contextlib.contextmanager
def abstract_params():
    """Create parameters on the meta device inside this context."""
    _ABSTRACT.append(True)
    try:
        yield
    finally:
        _ABSTRACT.pop()


def _device(gen: torch.Generator) -> torch.device:
    return torch.device("meta") if _ABSTRACT[-1] else gen.device


def truncated_normal(gen: torch.Generator, shape, stddev: float, dtype):
    """Normal truncated at ±2σ, drawn in f32, cast, then scaled by σ."""
    x = torch.empty(tuple(shape), dtype=torch.float32, device=_device(gen))
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
        return torch.zeros(shape, dtype=dtype, device=_device(gen))
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=_device(gen))
    raise ValueError(f"unknown init {init!r}")
