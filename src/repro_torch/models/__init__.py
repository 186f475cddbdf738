"""repro_torch.models — the decoders and encoder-decoders with
ABFP-dispatched matmuls: layers, the MoE block, the recurrent blocks, the
stub frontends, the LM (params, encoder,
teacher-forced forward with DNF noise and remat, DNF capture, decode
tick, chunked prefill, sampling), packing and conversion of the JAX
package's parameters."""

from repro_torch.models.layers import (  # noqa: F401
    Numerics,
    attention_block,
    chunked_attention,
    decode_attention,
    im2col,
    mlp_block,
    rmsnorm,
    rope,
    train_attention,
)
from repro_torch.models.lm import (  # noqa: F401
    abstract_params,
    clone_state,
    decode_step,
    encode,
    encode_cross_kv,
    forward,
    forward_capture,
    init_decode_state,
    init_params,
    lm_head_logits,
    param_count,
    prefill,
    sample_tokens,
)
from repro_torch.models.packing import (  # noqa: F401
    pack_model_params,
    packed_param_bytes,
)
