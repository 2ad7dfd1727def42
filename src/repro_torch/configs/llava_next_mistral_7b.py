"""llava-next-mistral-7b [vlm] — mistral-7b backbone, anyres tiling
frontend STUB (input_specs provides patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, d_head=128,
    vision_tokens=576,   # one 24x24 patch grid per image (stub)
    sparsity=SparsityConfig(enabled=True),
))
