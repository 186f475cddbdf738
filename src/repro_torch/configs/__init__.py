"""repro_torch.configs — the 10 architectures + shapes + registry."""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    smoke_config,
)

# Importing registers each architecture.
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b,
    gemma_7b,
    granite_moe_1b_a400m,
    kimi_k2_1t_a32b,
    phi_3_vision_4_2b,
    recurrentgemma_2b,
    smollm_360m,
    tinyllama_1_1b,
    whisper_base,
    xlstm_350m,
)

ALL_ARCHS = list_archs()
