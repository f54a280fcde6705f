"""whisper-tiny [audio] — encoder-decoder with (stubbed) conv frontend.

[arXiv:2212.04356]
4L encoder + 4L decoder, d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
The mel-spectrogram + conv feature extractor is a STUB per the assignment:
input_specs() supplies 1500 precomputed frame embeddings.
long_500k skipped: the whisper decoder family is architecturally capped at
short transcripts; 500k-token decode is meaningless for it (DESIGN.md §6).
Copied from `repro.configs.whisper_tiny`; both configs must stay equal.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-tiny",
        family="encdec",
        source="arXiv:2212.04356",
        num_layers=4,  # decoder layers
        encoder_layers=4,
        encoder_seq=1500,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51_865,
        rope_theta=10_000.0,  # (whisper uses learned pos; we use rope - noted)
        tie_embeddings=True,
        max_seq=32_768,
        split_layers=2,  # client tower = bottom half of the audio encoder
        scan_layers=False,  # 4 layers; unrolled compiles fine
    ),
    smoke=ModelConfig(
        name="whisper-tiny",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        encoder_seq=30,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        split_layers=1,
        num_clients=2,
        dtype="float32",
        scan_layers=False,
        remat="none",
    ),
)
