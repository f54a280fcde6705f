"""deepseek-moe-16b [moe] — fine-grained experts, 2 shared + 64 routed top-6.

[arXiv:2401.06066]
28L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=102400.
First layer is dense (d_ff=10944 in the release; we keep the assigned 1408
granularity scaled: dense lead layer uses 8x expert width).
Full attention -> long_500k skipped.
Copied from `repro.configs.deepseek_moe_16b`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        source="arXiv:2401.06066",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=11264,  # dense lead layer width (8 x 1408)
        vocab_size=102_400,
        num_experts=64,
        experts_per_token=6,
        num_shared_experts=2,
        moe_d_ff=1408,
        first_dense_layers=1,
        rope_theta=10_000.0,
        tie_embeddings=False,
        max_seq=131_072,
        split_layers=2,
        fsdp=True,
    ),
    smoke=ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        num_shared_experts=1,
        moe_d_ff=64,
        capacity_factor=8.0,  # no-drop for prefill/decode consistency tests
        first_dense_layers=1,
        tie_embeddings=False,
        split_layers=1,
        num_clients=2,
        dtype="float32",
        scan_layers=False,
        remat="none",
    ),
)
