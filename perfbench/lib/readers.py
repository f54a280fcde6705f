"""What the per-layer metric readers share: the calls of K2 and K3 that a
cell's step makes by design, and their bounds from the frozen cost models.

A roofline share sums the bound of every call the stretch ran over the
kernel's time there. The trace names the calls but not their shapes, so
each call is given the mean bound of the calls the step makes by design
(a training round: every attention or Mamba layer once per client tower
at the client's batch and once on the server at all clients' rows; the
recomputation under remat repeats them all alike)."""
from __future__ import annotations

from perfbench.reference.model import layer_kinds
from perfbench.yardstick import costs, peaks

MATMUL = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitkreduce", "cublas")


def is_matmul(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in MATMUL)


def forward(name: str) -> bool:
    low = name.lower()
    return "bwd" not in low and "backward" not in low


def _split(cfg, kinds_of):
    kinds = layer_kinds(cfg)
    split = cfg["split_layers"]
    return (sum(k in kinds_of for k in kinds[:split]),
            sum(k in kinds_of for k in kinds[split:]))


def train_calls(cfg: dict, traffic: dict, kernel: str):
    """[(calls a round, bound s of one)] of K2 ("k2") or K3 ("k3")."""
    M, b, S = traffic["num_clients"], traffic["batch_per_client"], traffic["seq_len"]
    item = costs.ITEMSIZE[cfg["dtype"]]
    if kernel == "k2":
        tower, server = _split(cfg, ("shared_attn", "dense_lead", "moe"))
        H, Hkv, D = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]

        def bound(B):
            c = costs.attention_cost(B, S, S, H, Hkv, D, True, 0, item)
            return peaks.bound_s(c.flops, c.bytes, cfg["dtype"])
    else:
        tower, server = _split(cfg, ("mamba", "shared_attn"))
        d_in = cfg["ssm_expand"] * cfg["d_model"]
        P, N, chunk = cfg["ssm_headdim"], cfg["ssm_state"], cfg["ssm_chunk"]
        L = -(-S // chunk) * chunk

        def bound(B):
            c = costs.scan_cost(B, L, d_in // P, P, N, chunk, item, False)
            return peaks.bound_s(c.flops, c.bytes, cfg["dtype"])
    return [(tower * M, bound(b)), (server, bound(M * b))]


def roofline_pct(calls, seen: int, seconds: float):
    """100 x (seen calls at the designed mean bound) / their time; None
    when the stretch ran none."""
    n = sum(c for c, _ in calls)
    if not seen or not n or seconds <= 0:
        return None
    mean = sum(c * t for c, t in calls) / n
    return 100.0 * seen * mean / seconds

