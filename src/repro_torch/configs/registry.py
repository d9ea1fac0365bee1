"""Architecture registry: full configs, smoke (reduced) configs, shape gating.

``get_config(name)`` returns the exact assigned configuration;
``smoke_config(name)`` returns a reduced same-family config that runs a
forward/train step on CPU in seconds.  In the port, ``qwen3-1.7b`` runs at
full width on the card (``launch/serve.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (
    arctic_480b,
    command_r_plus_104b,
    minitron_8b,
    musicgen_medium,
    olmoe_1b_7b,
    pixtral_12b,
    qwen3_1p7b,
    recurrentgemma_2b,
    rwkv6_7b,
    starcoder2_15b,
)
from repro_torch.configs.base import (
    LONG_500K,
    SHAPES,
    FrontendConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
)

_MODULES = (
    minitron_8b,
    qwen3_1p7b,
    starcoder2_15b,
    command_r_plus_104b,
    arctic_480b,
    olmoe_1b_7b,
    recurrentgemma_2b,
    rwkv6_7b,
    pixtral_12b,
    musicgen_medium,
)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def list_archs() -> List[str]:
    return list(ARCHS.keys())


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cells(include_multipod: bool = False):
    """All assigned (arch, shape) cells honoring the long_500k gating.

    ``long_500k`` is a 524k-token decode: only sub-quadratic architectures
    (RG-LRU hybrid, RWKV) run it; pure full-attention archs skip it (recorded
    in DESIGN.md §Arch-applicability).
    """
    out = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            if shape.name == LONG_500K.name and not arch.sub_quadratic:
                continue
            out.append((arch.name, shape.name))
    return out


def shape_applicable(arch: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == LONG_500K.name:
        return arch.sub_quadratic
    return True


# ---------------------------------------------------------------------------
# Reduced smoke configs — same family / same block pattern, tiny dims.
# ---------------------------------------------------------------------------

def smoke_config(name: str) -> ModelConfig:
    full = get_config(name)
    kw = dataclasses.asdict(full)
    # Rebuild nested dataclasses (asdict flattens them into dicts).
    if kw.get("moe"):
        kw["moe"] = MoEConfig(
            num_experts=4,
            top_k=min(2, full.moe.top_k),
            d_ff=64,
            dense_residual=full.moe.dense_residual,
            capacity_factor=2.0,
        )
    if kw.get("frontend"):
        kw["frontend"] = FrontendConfig(kind=full.frontend.kind, num_positions=4)
    pat = full.block_pattern
    kw.update(
        name=f"{full.name}-smoke",
        num_layers=max(2, len(pat)) + (1 if len(pat) > 1 else 0),  # exercise pattern + remainder
        d_model=64,
        num_heads=4 if full.num_heads else 0,
        num_kv_heads=min(full.num_kv_heads, 2) if full.num_kv_heads else 0,
        head_dim=16 if full.num_heads else 0,
        d_ff=96,
        vocab_size=512,
        window=8 if full.window else 0,
        lru_width=64 if full.lru_width else 0,
        rwkv_head_dim=16,
    )
    return ModelConfig(**kw)


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")
SMOKE_DECODE = ShapeConfig("smoke_decode", seq_len=32, global_batch=2, kind="decode")
SMOKE_PREFILL = ShapeConfig("smoke_prefill", seq_len=32, global_batch=2, kind="prefill")
