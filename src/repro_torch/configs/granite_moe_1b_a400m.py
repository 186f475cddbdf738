"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=512,              # per-expert hidden
        vocab_size=49_155,
        mlp_type="swiglu",
        num_experts=32,
        experts_per_token=8,
    )
