"""arctic-480b — [hf:Snowflake/snowflake-arctic-base; hf].

[moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 PLUS a parallel dense residual FFN (dense-MoE hybrid).
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    block_pattern=(ATTN,),
    gated_mlp=True,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff=4864, dense_residual=True),
    tie_embeddings=True,
    rope_theta=10_000.0,
    notes="128e top-2 + dense residual; train memory needs ZeRO-over-pod + bf16 opt states (see EXPERIMENTS.md)",
)
