"""zamba2-7b [hybrid] — Mamba2 backbone + ONE shared attention block
applied every 6th layer (weight-shared, zamba design). ssm_state=64.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000, d_head=112,
    ssm_state=64, ssm_expand=2, hybrid_attn_every=6,
    attn_window=4096,  # shared attn runs windowed at 500k ctx (DESIGN.md)
    sparsity=SparsityConfig(enabled=True),
))
