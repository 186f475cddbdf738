"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM; hf]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49_152,
        mlp_type="swiglu",
    )
