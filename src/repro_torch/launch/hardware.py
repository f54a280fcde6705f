"""The card's peaks, in one place: the dry-run's capacity check and the
kernels' bounds (`chip_smoke.py`) read them from here.

Every number is for an NVIDIA H100 80GB HBM3 at a 700.00 W power limit,
as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` names
that card: NVIDIA's data sheet for the SXM part, dense rates without
sparsity. A card set below 700 W runs slower under load than these
rates say. (The reference's `launch/mesh.py` keeps a TPU's constants;
they describe another chip and are not carried over.)
"""
from __future__ import annotations

from typing import Tuple

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# dense peaks by dtype; float32 is the rate outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# device memory of the H100 80GB HBM3 as torch reports it
# (`get_device_properties(0).total_memory`); used only for a dry-run asked
# to run under `--device cpu`, which has no card to ask
MEMORY_BYTES = 85_017_493_504


def memory_bytes(device=None) -> int:
    """The device memory a program must fit in: the card's own total on a
    CUDA device, else MEMORY_BYTES (the H100's)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return MEMORY_BYTES


def bound_ms(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The least time the card could take for `flops` operations in
    `dtype` ("bfloat16" or "float32") that move `nbytes`: the larger of
    the bytes over the memory rate and the operations over the peak, in
    ms, and which of the two bounds it ("bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
