from repro_torch.configs.base import (
    ModelConfig,
    ShapeConfig,
    INPUT_SHAPES,
    get_config,
    list_configs,
    register,
)

# importing the modules registers their configs (only the ported slice's)
from repro_torch.configs import gemma3_12b  # noqa: F401
