"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, d_head=64,
    tie_embeddings=True,
    sparsity=SparsityConfig(enabled=True, sparsity=0.85, block_m=64, block_n=64),
    notes="llama-arch small; d_model=960 -> d_head=64 (15H)",
))
