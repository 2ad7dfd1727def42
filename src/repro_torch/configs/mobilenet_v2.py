"""MobileNet-V2 — the paper's dense model comparison vs Wu et al."""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="mobilenet_v2", family="cnn",
    n_layers=53, d_model=1280, n_heads=1, d_ff=0, vocab_size=1000,
    sparsity=SparsityConfig(enabled=False),
))
