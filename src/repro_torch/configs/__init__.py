from repro_torch.configs.base import (
    LM_ARCHS, ModelConfig, SparsityConfig, get_config, register,
)
