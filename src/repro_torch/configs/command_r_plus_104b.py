"""command-r-plus-104b — [hf:CohereForAI/c4ai-command-r-v01 family; unverified].

[dense] 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
Cohere: parallel attention+FFN block, no biases, tied embeddings, SwiGLU.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256_000,
    block_pattern=(ATTN,),
    gated_mlp=True,
    parallel_block=True,
    use_bias=False,
    tie_embeddings=True,
    rope_theta=75_000_000.0,
    notes="GQA kv=8, no-bias, parallel block",
)
