"""rwkv6-1.6b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536, d_head=64,
    attn_free=True,
    sparsity=SparsityConfig(enabled=True),
))
