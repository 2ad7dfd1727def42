"""granite-moe-3b-a800m [moe] — 40 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155, d_head=64,
    moe=True, n_experts=40, top_k=8, moe_d_ff=512,
    tie_embeddings=True,
    sparsity=SparsityConfig(enabled=True, block_m=64, block_n=64),
))
