"""llama-3.2-vision-11b [vlm] — cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision]
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer is a
cross-attention layer attending to (stubbed) vision patch embeddings.
Full self-attention -> long_500k is skipped (see DESIGN.md §6).
Copied from `repro.configs.llama_3_2_vision_11b`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128_256,
        rope_theta=500_000.0,
        tie_embeddings=False,
        cross_attn_every=5,
        vis_seq=1601,     # 1 tile of 1601 patch embeddings (stub frontend)
        vis_dim=1280,     # pre-projector ViT-H width
        max_seq=131_072,
        split_layers=4,
        fsdp=True,
    ),
    smoke=ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=False,
        cross_attn_every=2,
        vis_seq=17,
        vis_dim=64,
        split_layers=1,
        num_clients=2,
        dtype="float32",
        scan_layers=False,
        remat="none",
    ),
)
