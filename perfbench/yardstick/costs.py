"""Operations and bytes of one call of each of the program's kernels, from
its shapes: frozen copies of the cost models in the program's
`kernels/*/ops.py` that the cells read (`update_cost`, `attention_cost`,
`scan_cost`), each input read once and each output written once.
Workspace is left out: it is not part of the work."""
from __future__ import annotations

from typing import NamedTuple

ITEMSIZE = {"bfloat16": 2, "float32": 4}


class Cost(NamedTuple):
    flops: int
    bytes: int


def update_cost(numel: int, itemsize: int) -> Cost:
    """K1 over `numel` elements: p and g read, p written; a multiply and a
    subtract an element."""
    return Cost(2 * numel, 3 * numel * itemsize)


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    if not causal:
        return Sq * Sk
    S = Sq
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_cost(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
                   causal: bool, window: int, itemsize: int) -> Cost:
    """K2's forward: q and the output [B, Sq, Hq, D], k and v [B, Sk, Hkv,
    D] moved once; two products of 2 D operations for every visible
    (query, key) pair of every query head."""
    return Cost(4 * D * Hq * B * visible_pairs(Sq, Sk, causal, window),
                2 * (B * Sq * Hq * D + B * Sk * Hkv * D) * itemsize)


def scan_cost(B: int, L: int, H: int, P: int, N: int, chunk: int, itemsize: int,
              with_state: bool) -> Cost:
    """K3's forward: x and y [B, L, H, P] and Bm, Cm [B, L, N] in the
    compute dtype, dt [B, L, H] and A [H] in f32, the final state (and the
    initial one when given) [B, H, P, N] f32; the chunked scan's products."""
    nbytes = (2 * B * L * H * P + 2 * B * L * N) * itemsize + 4 * (B * L * H + H) \
        + 4 * B * H * P * N * (2 if with_state else 1)
    flops = B * H * 2 * L * (chunk * N + chunk * P // 2 + 2 * P * N)
    return Cost(flops, nbytes)

