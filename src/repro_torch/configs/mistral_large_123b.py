"""mistral-large-123b [dense].

[hf:mistralai/Mistral-Large-Instruct-2407]
88L d_model=12288 96H (GQA kv=8, head_dim=128) d_ff=28672 vocab=32768.
Pure full attention -> long_500k skipped. The biggest assigned model; FSDP +
remat + microbatching are on by default (see EXPERIMENTS.md §Perf).
Copied from `repro.configs.mistral_large_123b`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mistral-large-123b",
        family="dense",
        source="hf:mistralai/Mistral-Large-Instruct-2407",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32_768,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        max_seq=131_072,
        split_layers=4,
        fsdp=True,
        remat="full",
        microbatches=8,
    ),
    smoke=ModelConfig(
        name="mistral-large-123b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        head_dim=16,
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
