"""starcoder2-15b — [arXiv:2402.19173; hf].

[dense] 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
StarCoder2: GQA, RoPE, non-gated GeLU MLP (4x), biases on projections.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    block_pattern=(ATTN,),
    gated_mlp=False,
    use_bias=True,
    tie_embeddings=True,
    rope_theta=100_000.0,
    notes="GQA kv=4, RoPE",
)
