"""ResNet-50 — the paper's primary evaluation network (85% sparse)."""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="resnet50", family="cnn",
    sparsity=SparsityConfig(enabled=True, sparsity=0.85, block_m=32, block_n=32),
    notes="paper's sparse ResNet-50 V1",
))
