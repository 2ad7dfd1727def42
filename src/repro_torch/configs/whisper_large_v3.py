"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB (input_specs
provides precomputed 1500-frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig, SparsityConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866, d_head=64,
    encoder_layers=32, encoder_seq=1500,
    sparsity=SparsityConfig(enabled=True, block_m=64, block_n=64),
))
