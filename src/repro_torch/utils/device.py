"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a silent fall back from one to the other."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is false; pass "
            "device='cpu' to run on the CPU")
    return dev


def generator(device, seed: int) -> torch.Generator:
    """A seeded generator on `device` (parameters are drawn on the device
    they live on)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
