"""MobileNet-V1 — the paper's dense model comparison (Table IV)."""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="mobilenet_v1", family="cnn",
    sparsity=SparsityConfig(enabled=False),
))
