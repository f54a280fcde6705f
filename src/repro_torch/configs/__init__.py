from repro_torch.configs.base import (
    ModelConfig,
    ShapeConfig,
    INPUT_SHAPES,
    get_config,
    list_configs,
    register,
)

# importing the modules registers their configs (every config of the
# reference)
from repro_torch.configs import (  # noqa: F401
    deepseek_7b,
    deepseek_moe_16b,
    gemma3_12b,
    llama_3_2_vision_11b,
    mamba2_130m,
    mistral_large_123b,
    mistral_nemo_12b,
    paper_mlp,
    paper_resnet,
    qwen3_moe_30b_a3b,
    whisper_tiny,
    zamba2_7b,
)
