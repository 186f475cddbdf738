"""phi-3-vision-4.2b — phi3-mini backbone + CLIP vision STUB (input_specs()
provides precomputed patch embeddings)
[hf:microsoft/Phi-3-vision-128k-instruct; hf]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32_064,
        mlp_type="swiglu",
        frontend="vision_stub",
    )
