"""ResNet-50 — the paper's primary evaluation network (85% sparse)."""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

# d_model/n_layers unused by the CNN path; kept for uniform registry typing.
CONFIG = register(ModelConfig(
    name="resnet50", family="cnn",
    n_layers=50, d_model=2048, n_heads=1, d_ff=0, vocab_size=1000,
    sparsity=SparsityConfig(enabled=True, sparsity=0.85, block_m=32, block_n=32),
    notes="paper's sparse ResNet-50 V1",
))
