"""zamba2-7b [hybrid] — Mamba2 backbone + *shared* attention block.

[arXiv:2411.15242]
81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Zamba2's hallmark: one attention+FFN block whose parameters are SHARED across
all its applications (every 6th layer) — a natural server-side residence for
the MTSL split. Hybrid -> runs long_500k (Mamba state + a handful of
shared-attn KV caches).
Copied from `repro.configs.zamba2_7b`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32_000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv_width=4,
        ssm_chunk=128,
        shared_attn_every=6,
        rope_theta=10_000.0,
        tie_embeddings=True,
        max_seq=524_288,
        split_layers=5,
        fsdp=True,
    ),
    smoke=ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=32,
        ssm_conv_width=4,
        ssm_chunk=16,
        shared_attn_every=2,
        split_layers=1,
        num_clients=2,
        dtype="float32",
        scan_layers=False,
        remat="none",
    ),
)
