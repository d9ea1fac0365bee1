"""qwen3-1.7b — [hf:Qwen/Qwen3-8B family; hf].

[dense] 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
Qwen3: per-head RMS qk-norm, SwiGLU, tied embeddings, RoPE theta 1e6.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    block_pattern=(ATTN,),
    qk_norm=True,
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    notes="qk_norm + GQA",
)
