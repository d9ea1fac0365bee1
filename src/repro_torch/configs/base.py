"""Configuration dataclasses of the LM stack (a copy of the JAX package's
``configs/base.py``: plain Python, so the port keeps its own).

Every assigned architecture is expressed as a :class:`ModelConfig`; every
assigned input shape as a :class:`ShapeConfig`.  Configs are plain frozen
dataclasses so they hash, print, and diff cleanly, and so they can key
dictionaries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds understood by repro_torch.models.transformer
# ---------------------------------------------------------------------------
ATTN = "attn"              # global causal attention (GQA)
ATTN_LOCAL = "attn_local"  # sliding-window causal attention
RECURRENT = "rglru"        # RG-LRU recurrent block (RecurrentGemma / Griffin)
RWKV = "rwkv6"             # RWKV-6 time-mix + channel-mix (attention free)

BLOCK_KINDS = (ATTN, ATTN_LOCAL, RECURRENT, RWKV)

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden dim
    dense_residual: bool = False  # Arctic-style parallel dense FFN path
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub (per assignment the frontend is precomputed).

    ``input_specs()`` provides ``(batch, num_positions, d_model)`` embeddings
    that are concatenated in front of the token embeddings.
    """

    kind: str            # "patch" (vision) | "frame" (audio conditioning)
    num_positions: int   # patches / conditioning frames per example


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A decoder-style LM backbone configuration.

    The single Transformer implementation in ``repro_torch.models`` consumes this
    config and covers dense, MoE, hybrid-recurrent, RWKV, VLM-backbone and
    audio-backbone families.
    """

    name: str
    family: str                      # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int                # KV heads (GQA); == num_heads for MHA
    d_ff: int                        # dense FFN hidden dim (0 = MoE only)
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- block structure -------------------------------------------------
    block_pattern: Tuple[str, ...] = (ATTN,)   # cycled over layers
    window: int = 0                  # sliding window for ATTN_LOCAL blocks

    # --- attention options ------------------------------------------------
    qk_norm: bool = False            # Qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10_000.0
    use_rope: bool = True
    attn_logit_softcap: float = 0.0
    parallel_block: bool = False     # Cohere-style parallel attn+FFN
    use_bias: bool = False

    # --- FFN --------------------------------------------------------------
    gated_mlp: bool = True           # SwiGLU (gate+up+down) vs GeLU (up+down)
    moe: Optional[MoEConfig] = None

    # --- RG-LRU (hybrid) / RWKV -------------------------------------------
    lru_width: int = 0               # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4            # temporal conv in recurrent block
    rwkv_head_dim: int = 64

    # --- embeddings / output ----------------------------------------------
    tie_embeddings: bool = True
    frontend: Optional[FrontendConfig] = None
    num_codebooks: int = 1           # MusicGen-style parallel codebooks

    # --- numerics -----------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master parameter dtype

    # --- performance knobs (hillclimbed in EXPERIMENTS.md §Perf) ----------
    ce_impl: str = "gather"          # "gather" | "onehot" (TP-friendly CE)
    dense_attn_max_seq: int = 8192   # above -> chunked flash attention
    shard_attn_heads: bool = False   # constrain q/k/v + scores onto 'model'
    moe_impl: str = "gather"         # "gather" (GSPMD) | "ep" (shard_map EP)
    scores_dtype: str = "float32"    # attention softmax accumulation dtype
    sharding: str = "2d"             # "2d" (FSDP+TP) | "fsdp" (pure ZeRO DP)
    save_attn_out: bool = False      # remat policy: keep attention outputs
    decode_unroll: bool = False      # unroll decode layer loop (in-place KV)
    attn_kernel: bool = False        # hand-written flash kernel (CUDA tensors)

    # --- feature flags (paper technique integration) ----------------------
    sub_quadratic: bool = False      # True -> long_500k shape is runnable
    notes: str = ""

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        for kind in self.block_pattern:
            assert kind in BLOCK_KINDS, kind
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived sizes ------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind of every layer, pattern cycled to num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    # -- parameter counting (used for MODEL_FLOPS = 6 N D) -------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts (total and active-per-token)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        counts = {"embed": v * d}
        per_layer_total = 0
        per_layer_active = 0
        kinds = self.layer_kinds()
        for kind in kinds:
            lt = la = 0
            if kind in (ATTN, ATTN_LOCAL):
                attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qk_norm:
                    attn += 2 * self.head_dim
                lt += attn
                la += attn
            elif kind == RECURRENT:
                w = self.lru_width or d
                # in/out proj (x2 branches), conv1d, RG-LRU gates (a, i), recur params
                rec = 2 * d * w + w * d + self.conv1d_width * w + 2 * (w * w // 1) + 2 * w
                lt += rec
                la += rec
            elif kind == RWKV:
                h = d // self.rwkv_head_dim
                # time-mix: r,k,v,g,o projections + data-dependent decay lora
                tm = 5 * d * d + d * 64 * 2 + h * self.rwkv_head_dim
                lt += tm
                la += tm
            # FFN
            nmul = 3 if self.gated_mlp else 2
            if self.moe is not None:
                moe_p = self.moe.num_experts * nmul * d * self.moe.d_ff
                lt += moe_p + d * self.moe.num_experts  # + router
                la += self.moe.top_k * nmul * d * self.moe.d_ff + d * self.moe.num_experts
                if self.moe.dense_residual:
                    lt += nmul * d * dff
                    la += nmul * d * dff
            elif kind != RWKV:
                lt += nmul * d * dff
                la += nmul * d * dff
            else:  # RWKV channel-mix: r, k, v mats (k: d->dff, v: dff->d, r: d->d)
                cm = d * dff + dff * d + d * d
                lt += cm
                la += cm
            # two layer norms
            lt += 2 * d
            la += 2 * d
            per_layer_total += lt
            per_layer_active += la
        counts["layers_total"] = per_layer_total
        counts["layers_active"] = per_layer_active
        head = 0 if self.tie_embeddings else v * d
        counts["lm_head"] = head
        counts["total"] = counts["embed"] + per_layer_total + head + d  # final norm
        counts["active"] = counts["embed"] + per_layer_active + head + d
        return counts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape (workload cell)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


# The four assigned LM shapes -------------------------------------------------
TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def parse_overrides(s: str) -> dict:
    """'ce_impl=onehot,dense_attn_max_seq=2048' -> typed override dict."""
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """End-to-end training run configuration."""

    model: str = "qwen3-1.7b"
    shape: str = "train_4k"
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    pipelined_clipping: bool = False   # the paper's split-phase collective
    optimizer: str = "adamw"           # "adamw" | "krylov_newton"
    optimizer_state_dtype: str = "float32"  # "bfloat16" for XXL models
    zero_over_pod: bool = False        # shard optimizer state over pod axis
    remat: str = "full"                # "none" | "full"
    seed: int = 0
    microbatch: int = 0                # 0 = no microbatching
    grad_compression: str = "none"     # "none" | "int8"
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
