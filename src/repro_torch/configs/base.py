"""Model / shape configuration dataclasses and the architecture registry.

Field for field the same as the JAX package's ``configs/base.py``; only the
dtype fields hold ``torch.dtype`` values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture definition (static, hashable)."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default: d_model // num_heads
    mlp_type: str = "swiglu"                # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"              # rmsnorm | layernorm
    rope_fraction: float = 1.0              # 0.5 = chatglm partial rotary
    rope_theta: float = 10_000.0
    pos_type: str = "rope"                  # rope | absolute (whisper)
    embed_scale: bool = False               # gemma-style sqrt(d) input scaling
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # hybrid (recurrentgemma / Griffin)
    block_pattern: Tuple[str, ...] = ()
    window_size: int = 0                    # sliding-window attention width
    lru_width: int = 0                      # RG-LRU state width (0 => d_model)
    conv_width: int = 4                     # temporal conv in recurrent block
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    frontend: str = "none"                  # none | audio_stub | vision_stub
    # numerics
    param_dtype: Any = torch.bfloat16
    activation_dtype: Any = torch.bfloat16
    # attention memory blocking
    attn_chunk: int = 512
    # rematerialize each layer's activations (training memory)
    remat: bool = False
    # Decode KV cache as int8 codes with a per-(token, head) ABFP scale.
    kv_quant: bool = False
    # Cacheless attention through the flash-attention kernel
    # (kernels/flash_attention.py) instead of chunked_attention.
    use_flash_attention: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def attention_type(self) -> str:
        """full | sliding | hybrid | recurrent-only."""
        if self.block_pattern:
            kinds = set(self.block_pattern)
            if kinds == {"attention"}:
                return "full"
            if "attention" in kinds:
                return "hybrid"
            return "recurrent"
        return "full"

    @property
    def supports_long_context_decode(self) -> bool:
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.window_size > 0:
            return True
        return False

    def layer_kind(self, layer_idx: int) -> str:
        if not self.block_pattern:
            return "attention"
        return self.block_pattern[layer_idx % len(self.block_pattern)]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict = {}


def register(cfg_fn):
    """Decorator: registers ``<module>.config()`` under its arch id."""
    cfg = cfg_fn()
    _REGISTRY[cfg.name] = cfg_fn
    return cfg_fn


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family variant for CPU tests: small depth/width, few
    experts, tiny vocab, float32 — same code paths."""
    cfg = get_config(name)
    updates = dict(
        num_layers=min(cfg.num_layers, len(cfg.block_pattern) or 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=(min(cfg.num_kv_heads, 2)
                      if cfg.num_kv_heads < cfg.num_heads else 4),
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        lru_width=128 if cfg.lru_width else 0,
        window_size=min(cfg.window_size, 64) if cfg.window_size else 0,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        param_dtype=torch.float32,
        activation_dtype=torch.float32,
        attn_chunk=64,
    )
    if cfg.block_pattern:
        updates["num_layers"] = len(cfg.block_pattern)
    return dataclasses.replace(cfg, **updates)
