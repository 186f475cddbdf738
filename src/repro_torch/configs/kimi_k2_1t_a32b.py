"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 (paper-table)
[arXiv:2501.kimi2; unverified]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=112,          # 7168 / 64
        d_ff=2048,             # per-expert hidden
        vocab_size=163_840,
        mlp_type="swiglu",
        num_experts=384,
        experts_per_token=8,
    )
