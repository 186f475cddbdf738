"""gemma-7b — GeGLU, head_dim=256, 16H/16KV [arXiv:2403.08295; hf]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24_576,
        vocab_size=256_000,
        mlp_type="geglu",
        embed_scale=True,
        tie_embeddings=True,
    )
