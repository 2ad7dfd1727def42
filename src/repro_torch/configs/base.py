"""Model configuration for the port: the part of the reference's
``ModelConfig`` that a CNN reads (``src/repro/configs/base.py``).

The LM configs are not ported yet (ROADMAP Queue 1, LM side); their
names are listed so that asking for one says so instead of failing as
an unknown name."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SparsityConfig:
    """HPIPE weight sparsity settings (block-level zero skipping)."""
    enabled: bool = False
    sparsity: float = 0.85        # fraction of weight *blocks* pruned
    block_m: int = 128            # block rows  (input-channel dim)
    block_n: int = 128            # block cols  (output-channel dim)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # cnn (the only family ported so far)
    sparsity: SparsityConfig = field(default_factory=SparsityConfig)
    notes: str = ""


#: the reference's LM architectures, not ported yet
LM_ARCHS = ("smollm-360m", "mistral-nemo-12b", "qwen3-32b", "granite-20b",
            "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
            "whisper-large-v3", "zamba2-7b", "llava-next-mistral-7b",
            "rwkv6-1.6b")

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name in LM_ARCHS:
        raise NotImplementedError(
            f"{name!r} is an LM arch: ROADMAP Queue 1, LM side")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


ARCH_MODULES = ["resnet50", "mobilenet_v1", "mobilenet_v2"]


def _ensure_loaded() -> None:
    import importlib
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
