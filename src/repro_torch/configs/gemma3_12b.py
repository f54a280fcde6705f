"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family; 12B decoder config]
48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144.
Pattern: 5 sliding-window (1024) layers then 1 global layer, repeated.
Copied from `repro.configs.gemma3_12b`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma3-12b",
        family="dense",
        source="hf:google/gemma-3-1b-pt (gemma-3 family, 12B)",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262_144,
        attn_pattern=("swa", "swa", "swa", "swa", "swa", "full"),
        sliding_window=1024,
        rope_theta=1_000_000.0,
        max_seq=524_288,
        split_layers=6,  # one full 5:1 pattern unit in the client tower
        remat="block",
        fsdp=True,
    ),
    smoke=ModelConfig(
        name="gemma3-12b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_pattern=("swa", "full"),
        sliding_window=16,
        split_layers=1,
        num_clients=2,
        dtype="float32",
        scan_layers=False,
        remat="none",
    ),
)
