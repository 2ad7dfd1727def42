from repro_torch.configs.base import (
    CNN_SHAPES, ModelConfig, ShapeConfig, SHAPES, SparsityConfig,
    all_configs, applicable, get_config, reduced, register,
)
