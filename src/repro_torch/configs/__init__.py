from repro_torch.configs.base import (
    ModelConfig,
    ShapeConfig,
    INPUT_SHAPES,
    get_config,
    list_configs,
    register,
)

# importing the modules registers their configs (only the ported slices')
from repro_torch.configs import (  # noqa: F401
    gemma3_12b,
    mamba2_130m,
    paper_mlp,
    paper_resnet,
    zamba2_7b,
)
