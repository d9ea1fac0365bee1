"""minitron-8b — width-pruned Nemotron-4 15B [arXiv:2407.14679; hf].

[dense] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Nemotron family: squared-ReLU style non-gated MLP, untied embeddings.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    block_pattern=(ATTN,),
    gated_mlp=False,
    tie_embeddings=False,
    rope_theta=10_000.0,
    notes="pruned nemotron; GQA kv=8; relu^2 MLP approximated by GeLU MLP",
)
