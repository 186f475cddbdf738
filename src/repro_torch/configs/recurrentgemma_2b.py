"""recurrentgemma-2b — Griffin: RG-LRU + local attention, 1:2
[arXiv:2402.19427; hf]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        d_ff=7680,
        vocab_size=256_000,
        mlp_type="geglu",
        embed_scale=True,
        tie_embeddings=True,
        # 1:2 attention:recurrent — (R, R, A) cycled over 26 layers.
        block_pattern=("recurrent", "recurrent", "attention"),
        window_size=2048,
        lru_width=2560,
        conv_width=4,
    )
