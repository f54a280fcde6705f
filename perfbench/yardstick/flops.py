"""Model FLOPs: the operations that a forward (and, for training, its
backward) of the configuration needs, worked out from its widths and the
cell's shapes. No recomputed operation counts, and a token counts the
experts it is designed to use (its routed and shared experts), never
capacity padding. Elementwise work (norms, activations, softmax) is left
out; the depthwise conv and the SSD recurrence count their multiply-adds.
"""
from __future__ import annotations

from perfbench.reference.model import layer_kinds


def _per_token(cfg: dict):
    """(matmul weights a token passes through, attention applications,
    SSD layers) of one forward."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    H, Hkv, D = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    attn = d * H * D + 2 * d * Hkv * D + H * D * d
    weights, n_attn, n_ssd = d * V, 0, 0
    for kind in layer_kinds(cfg):
        if kind in ("mamba", "shared_attn"):
            d_in = cfg["ssm_expand"] * d
            Hs = d_in // cfg["ssm_headdim"]
            weights += d * (2 * d_in + 2 * cfg["ssm_state"] + Hs) + d_in * d
            n_ssd += 1
        if kind in ("shared_attn", "dense_lead"):
            weights += attn + 3 * d * cfg["d_ff"]
            n_attn += 1
        if kind == "moe":
            active = cfg["experts_per_token"] + cfg.get("num_shared_experts", 0)
            weights += attn + d * cfg["num_experts"] + 3 * d * cfg["moe_d_ff"] * active
            n_attn += 1
    return weights, n_attn, n_ssd


def forward_flops(cfg: dict, tokens: int, visible: int) -> float:
    """One forward over `tokens` positions whose causal attention sees
    `visible` (query, key) pairs in all."""
    weights, n_attn, n_ssd = _per_token(cfg)
    out = 2.0 * weights * tokens
    out += 4.0 * cfg["num_heads"] * cfg["head_dim"] * n_attn * visible
    if n_ssd:
        d_in = cfg["ssm_expand"] * cfg["d_model"]
        P, N, W = cfg["ssm_headdim"], cfg["ssm_state"], cfg["ssm_conv_width"]
        per = 4 * P * N * (d_in // P) + 2 * W * (d_in + 2 * N)
        out += float(n_ssd) * per * tokens
    return out


def train_round_flops(cfg: dict, M: int, b: int, S: int) -> float:
    """One mtsl round over M clients' b sequences of S tokens: forward and
    backward (twice the forward)."""
    rows = M * b
    return 3.0 * forward_flops(cfg, rows * S, rows * S * (S + 1) // 2)

