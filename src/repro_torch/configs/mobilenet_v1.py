"""MobileNet-V1 — the paper's dense model comparison (Table IV)."""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="mobilenet_v1", family="cnn",
    n_layers=28, d_model=1024, n_heads=1, d_ff=0, vocab_size=1000,
    sparsity=SparsityConfig(enabled=False),
))
