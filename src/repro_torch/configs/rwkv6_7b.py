"""rwkv6-7b — Finch [arXiv:2404.05892; hf].

[ssm] 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.
RWKV-6: data-dependent decay time-mix (head size 64) + channel-mix.
Sub-quadratic (constant state) -> long_500k shape is runnable.
"""
from repro_torch.configs.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab_size=65_536,
    block_pattern=(RWKV,),
    rwkv_head_dim=64,
    use_rope=False,
    gated_mlp=False,
    tie_embeddings=False,
    sub_quadratic=True,
    notes="Finch: data-dependent decay; constant-size recurrent state",
)
