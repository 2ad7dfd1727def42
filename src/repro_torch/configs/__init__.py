from repro_torch.configs.base import (
    ModelConfig, SparsityConfig, get_config, reduced, register,
)
