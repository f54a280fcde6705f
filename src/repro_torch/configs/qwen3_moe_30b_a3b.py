"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, no shared experts.

[hf:Qwen/Qwen3-30B-A3B]
48L d_model=2048 32H (GQA kv=4, head_dim=128) per-expert d_ff=768
vocab=151936. Full attention -> long_500k skipped.
Copied from `repro.configs.qwen3_moe_30b_a3b`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=0,  # all layers MoE
        vocab_size=151_936,
        num_experts=128,
        experts_per_token=8,
        num_shared_experts=0,
        moe_d_ff=768,
        first_dense_layers=0,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        max_seq=131_072,
        split_layers=2,
        fsdp=True,
    ),
    smoke=ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=0,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        num_shared_experts=0,
        moe_d_ff=64,
        capacity_factor=8.0,  # no-drop for prefill/decode consistency tests
        tie_embeddings=False,
        split_layers=1,
        num_clients=2,
        dtype="float32",
        scan_layers=False,
        remat="none",
    ),
)
