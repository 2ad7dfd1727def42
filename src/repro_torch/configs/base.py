"""Model and shape configuration for the port (counterpart of the
reference's ``src/repro/configs/base.py``, every field and helper).

Every architecture the reference registers is a ``ModelConfig`` here,
with the reference's values; every input shape of its (arch x shape)
grid is a ``ShapeConfig``. Every LM family has its model code in
``models/lm.py``."""
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
    family: str                   # dense|moe|audio|hybrid|vlm|ssm|cnn
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0           # 0 -> = n_heads
    d_head: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0             # per-expert FFN hidden
    # --- SSM / hybrid ---
    ssm_state: int = 0            # mamba2 state size per head
    ssm_conv: int = 4             # conv1d width for mamba2
    ssm_expand: int = 2
    attn_free: bool = False       # rwkv6: no attention at all
    hybrid_attn_every: int = 0    # zamba2: shared attn block every k layers
    attn_window: int = 0          # sliding-window attention (0 = full causal)
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0          # frontend-stub sequence length (audio frames)
    # --- vlm ---
    vision_tokens: int = 0        # frontend-stub patch embeddings per image
    # --- HPIPE ---
    sparsity: SparsityConfig = field(default_factory=SparsityConfig)
    notes: str = ""

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k+ context?"""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dh = self.d_model, self.head_dim
        p = self.vocab_size * d                      # embedding
        if not self.tie_embeddings:
            p += self.vocab_size * d                 # lm head
        attn = (d * dh * self.n_heads + 2 * d * dh * self.kv_heads
                + dh * self.n_heads * d)
        if self.moe:
            ffn = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "ssm":                     # rwkv6
            tmix = 4 * d * d + d * (d // 16) * 2     # r,k,v,o + decay lora
            cmix = 2 * d * self.d_ff
            p += self.n_layers * (tmix + cmix)
        elif self.family == "hybrid":                # zamba2
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            p += self.n_layers * mamba
            if self.hybrid_attn_every:
                p += attn + 3 * d * self.d_ff        # ONE shared block
        else:
            p += self.n_layers * (attn + ffn)
        if self.encoder_layers:
            p += self.encoder_layers * (attn + 3 * d * self.d_ff)
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        all_exp = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        act_exp = self.n_layers * self.top_k * 3 * d * self.moe_d_ff
        return self.n_params() - all_exp + act_exp


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# image shapes for the paper's own CNNs
CNN_SHAPES = {
    "train_img": ShapeConfig("train_img", "train", 224, 256),
    "serve_img_b1": ShapeConfig("serve_img_b1", "prefill", 224, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Which (arch, shape) cells exist: CNNs take the image shapes, LMs
    the token shapes, and only the sub-quadratic LMs the 500k decode."""
    if cfg.family == "cnn":
        return shape.name in CNN_SHAPES
    if shape.name in CNN_SHAPES:
        return False
    if shape.name == "long_500k":
        return cfg.sub_quadratic()
    return True


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2 if not cfg.hybrid_attn_every else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=32,
        d_ff=256,
        vocab_size=512,
        moe_d_ff=64 if cfg.moe else 0,
        n_experts=4 if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        hybrid_attn_every=2 if cfg.hybrid_attn_every else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=32 if cfg.encoder_seq else 0,
        vision_tokens=16 if cfg.vision_tokens else 0,
        attn_window=64 if cfg.attn_window else 0,
        sparsity=dataclasses.replace(cfg.sparsity, block_m=16, block_n=16),
    )


#: the LM families whose model code is not ported yet, each with the
#: ROADMAP item that ports it: none (``models/lm.py::BLOCK_KINDS`` holds
#: every LM family of the registry)
UNPORTED_LM_FAMILIES: dict[str, str] = {}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


ARCH_MODULES = [
    "smollm_360m", "mistral_nemo_12b", "qwen3_32b", "granite_20b",
    "granite_moe_3b_a800m", "moonshot_v1_16b_a3b", "whisper_large_v3",
    "zamba2_7b", "llava_next_mistral_7b", "rwkv6_1p6b",
    "resnet50", "mobilenet_v1", "mobilenet_v2",
]


def _ensure_loaded() -> None:
    import importlib
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
