"""The decoder LM on PyTorch: every family of ``configs/registry``."""
from repro_torch.models.moe import capacity, moe_ffn  # noqa: F401
from repro_torch.models.recurrent import (  # noqa: F401
    RGLRUState,
    RWKVState,
    rglru_block,
    rwkv_channel_mix,
    rwkv_time_mix,
)
from repro_torch.models.transformer import (  # noqa: F401
    Hints,
    decode_step,
    embed_tokens,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    prefill,
    unembed,
)
