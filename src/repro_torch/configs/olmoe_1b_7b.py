"""olmoe-1b-7b — [arXiv:2409.02060; hf].

[moe] 16L d_model=2048 16H (MHA kv=16) d_ff=1024(expert) vocab=50304,
MoE 64 experts top-8, qk-norm.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50_304,
    block_pattern=(ATTN,),
    qk_norm=True,
    gated_mlp=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024, dense_residual=False),
    tie_embeddings=False,
    rope_theta=10_000.0,
    notes="64 experts top-8; 1B active / 7B total",
)
