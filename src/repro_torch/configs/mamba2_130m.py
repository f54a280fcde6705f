"""mamba2-130m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060]
24L d_model=768, ssm_state=128, d_inner=2*768=1536, headdim=64 (24 ssm heads),
vocab=50280. Sub-quadratic -> runs long_500k (O(1) decode state).
Copied from `repro.configs.mamba2_130m`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-130m",
        family="ssm",
        source="arXiv:2405.21060",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv_width=4,
        ssm_chunk=128,
        max_seq=1_048_576,
        split_layers=4,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=32,
        ssm_conv_width=4,
        ssm_chunk=16,
        split_layers=1,
        num_clients=2,
        dtype="float32",
        scan_layers=False,
        remat="none",
    ),
)
