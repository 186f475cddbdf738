"""whisper-base — enc-dec transformer backbone; the conv audio frontend is a
STUB (input_specs() provides precomputed frame embeddings)
[arXiv:2212.04356; unverified]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        num_layers=6,             # decoder layers
        num_encoder_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=51_865,
        mlp_type="gelu",
        norm_type="layernorm",
        pos_type="absolute",
        is_encoder_decoder=True,
        frontend="audio_stub",
    )
