"""repro_torch.models — the dense decoder with ABFP-dispatched matmuls:
layers, the LM (params, decode tick, chunked prefill, sampling), packing
and conversion of the JAX package's parameters."""

from repro_torch.models.layers import (  # noqa: F401
    Numerics,
    attention_block,
    decode_attention,
    mlp_block,
    rmsnorm,
    rope,
)
from repro_torch.models.lm import (  # noqa: F401
    clone_state,
    decode_step,
    init_decode_state,
    init_params,
    param_count,
    prefill,
    sample_tokens,
)
from repro_torch.models.packing import (  # noqa: F401
    pack_model_params,
    packed_param_bytes,
)
