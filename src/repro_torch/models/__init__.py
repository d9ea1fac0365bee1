"""The decoder LM (attention families) on PyTorch."""
from repro_torch.models.transformer import (  # noqa: F401
    Hints,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
)
