"""recurrentgemma-2b — Griffin [arXiv:2402.19427; hf].

[hybrid] 26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000.
Block pattern: (RG-LRU, RG-LRU, local-attn) — attention 1:2, window 2048.
Sub-quadratic -> long_500k shape is runnable.
"""
from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=(RECURRENT, RECURRENT, ATTN_LOCAL),
    window=2048,
    lru_width=2560,
    conv1d_width=4,
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    sub_quadratic=True,
    notes="RG-LRU + local attn 1:2; 26 = 8x(R,R,A) + (R,R)",
)
