"""pixtral-12b — [hf:mistralai/Pixtral-12B-2409; unverified].

[vlm] 40L d_model=5120 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=131072.
Backbone = Mistral-Nemo decoder; vision frontend is a STUB per the
assignment: input_specs() provides precomputed patch embeddings
(batch, 1024, d_model) occupying the first positions of the sequence.
"""
from repro_torch.configs.base import ATTN, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    block_pattern=(ATTN,),
    gated_mlp=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="patch", num_positions=1024),
    notes="pixtral-ViT frontend stubbed as precomputed patch embeddings",
)
