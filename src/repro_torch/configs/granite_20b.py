"""granite-20b [dense] — llama-arch, code, MQA (kv=1). [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, d_head=128,
    sparsity=SparsityConfig(enabled=True),
))
