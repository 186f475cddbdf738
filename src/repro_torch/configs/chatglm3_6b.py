"""chatglm3-6b — RoPE 2d (partial rotary), GQA kv=2 [arXiv:2406.12793; hf]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13_696,
        vocab_size=65_024,
        mlp_type="swiglu",
        rope_fraction=0.5,   # "RoPE 2d": rotary on half the head dim
    )
