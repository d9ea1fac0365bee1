"""musicgen-medium — [arXiv:2306.05284; hf].

[audio] 48L d_model=1536 24H (MHA kv=24, head_dim 64) d_ff=6144 vocab=2048.
Decoder-only over EnCodec tokens (4 parallel codebooks, embeddings summed,
one head per codebook — the delay pattern is handled by the data layer).
Conditioning frontend is a STUB: precomputed frame embeddings
(batch, 256, d_model) occupying the first positions.
"""
from repro_torch.configs.base import ATTN, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2_048,
    block_pattern=(ATTN,),
    gated_mlp=False,
    use_bias=True,
    use_rope=False,  # MusicGen uses learned sinusoidal offsets; we use learned abs pos
    tie_embeddings=False,
    num_codebooks=4,
    frontend=FrontendConfig(kind="frame", num_positions=256),
    notes="decoder-only over EnCodec tokens; 4 codebooks",
)
