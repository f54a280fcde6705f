"""deepseek-7b [dense] — llama-architecture MHA model.

[arXiv:2401.02954]
30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008 vocab=102400.
Pure full attention -> long_500k skipped (DESIGN.md §6).
Copied from `repro.configs.deepseek_7b`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-7b",
        family="dense",
        source="arXiv:2401.02954",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102_400,
        rope_theta=10_000.0,
        tie_embeddings=False,
        max_seq=131_072,
        split_layers=3,
        fsdp=True,
    ),
    smoke=ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=False,
        split_layers=1,
        num_clients=2,
        dtype="float32",
        scan_layers=False,
        remat="none",
    ),
)
