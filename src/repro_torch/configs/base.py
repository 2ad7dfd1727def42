"""Model configuration for the port: the part of the reference's
``ModelConfig`` that a CNN and a dense LM read
(``src/repro/configs/base.py``).

The LM fields are those of the dense family (GQA attention, gated FFN,
RoPE). The MoE, SSM, hybrid, encoder-decoder and VLM fields are not
ported with their families (ROADMAP Queue 1, the rest of the LM side);
asking for one of those archs says so instead of failing as an unknown
name."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SparsityConfig:
    """HPIPE weight sparsity settings (block-level zero skipping)."""
    enabled: bool = False
    sparsity: float = 0.85        # fraction of weight *blocks* pruned
    block_m: int = 128            # block rows  (input-channel dim)
    block_n: int = 128            # block cols  (output-channel dim)
    # which matmul families get pruned weights
    prune_ffn: bool = True
    prune_attn_proj: bool = True
    prune_vocab: bool = False     # embedding/logits stay dense


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # cnn | dense (the families ported so far)
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    n_kv_heads: int = 0           # 0 -> = n_heads
    d_head: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    attn_window: int = 0          # sliding-window attention (0 = full causal)
    sparsity: SparsityConfig = field(default_factory=SparsityConfig)
    notes: str = ""

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests: the reference's
    ``reduced`` on the fields ported here."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=32,
        d_ff=256,
        vocab_size=512,
        attn_window=64 if cfg.attn_window else 0,
        sparsity=dataclasses.replace(cfg.sparsity, block_m=16, block_n=16),
    )


#: the reference's LM architectures not ported yet, with the ROADMAP
#: item that ports each, named by its title
_LM_SIDE = "Queue 1, the rest of the LM side"
UNPORTED_LM_ARCHS = {
    "mistral-nemo-12b": f"{_LM_SIDE} (dense LMs beyond smollm-360m)",
    "qwen3-32b": f"{_LM_SIDE} (dense LMs beyond smollm-360m)",
    "granite-20b": f"{_LM_SIDE} (dense LMs beyond smollm-360m)",
    "granite-moe-3b-a800m": f"{_LM_SIDE} (MoE)",
    "moonshot-v1-16b-a3b": f"{_LM_SIDE} (MoE)",
    "whisper-large-v3": f"{_LM_SIDE} (whisper, encoder-decoder)",
    "zamba2-7b": f"{_LM_SIDE} (zamba2, hybrid)",
    "llava-next-mistral-7b": f"{_LM_SIDE} (llava, VLM)",
    "rwkv6-1.6b": f"{_LM_SIDE} (rwkv6, SSM)",
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name in UNPORTED_LM_ARCHS:
        raise NotImplementedError(
            f"{name!r} is not ported yet: ROADMAP "
            f"{UNPORTED_LM_ARCHS[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


ARCH_MODULES = ["resnet50", "mobilenet_v1", "mobilenet_v2", "smollm_360m"]


def _ensure_loaded() -> None:
    import importlib
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
