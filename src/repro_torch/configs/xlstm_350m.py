"""xlstm-350m — alternating sLSTM + mLSTM blocks [arXiv:2405.04517;
unverified].  d_ff=0: the xLSTM blocks carry their own projections."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        block_pattern=("mlstm", "slstm"),
    )
