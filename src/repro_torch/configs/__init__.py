from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    get_shape,
    reduced,
)
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
    "get_shape", "reduced", "get_config", "get_smoke_config", "list_archs",
]
