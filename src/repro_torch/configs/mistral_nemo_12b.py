"""mistral-nemo-12b [dense] — 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407]
40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.
Stock model is full attention (long_500k skipped); the beyond-paper
`--variant swa` build (decode_long_window=4096 ring KV) runs long_500k — see
DESIGN.md §6 and EXPERIMENTS.md §Perf.
Copied from `repro.configs.mistral_nemo_12b`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        source="hf:mistralai/Mistral-Nemo-Base-2407",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131_072,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        max_seq=524_288,
        split_layers=4,
        fsdp=True,
    ),
    smoke=ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
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

# beyond-paper sliding-window serving variant (enables long_500k decode)
SWA_VARIANT = register(
    CONFIG.with_updates(
        name="mistral-nemo-12b-swa",
        attn_pattern=("swa",),
        sliding_window=4096,
        decode_long_window=4096,
    ),
)
