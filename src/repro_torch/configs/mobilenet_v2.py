"""MobileNet-V2 — the paper's dense model comparison vs Wu et al."""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="mobilenet_v2", family="cnn",
    sparsity=SparsityConfig(enabled=False),
))
