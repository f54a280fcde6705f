"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), at its 700 W power
limit: NVIDIA's data sheet, dense rates without sparsity. A frozen copy
of the program's `launch/hardware.py` values, so the yardstick does not
move when the program changes."""
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
