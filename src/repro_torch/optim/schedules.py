"""Learning-rate schedules (pure functions of the step).

The port of the JAX package's ``optim/schedules.py``: float32 arithmetic,
a 0-d float32 tensor out.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup_cosine(step, *, base_lr, warmup_steps, total_steps,
                         min_ratio=0.1) -> torch.Tensor:
    step = _f32(step)
    warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, base_lr * cos)


def constant(step, *, base_lr, **_) -> torch.Tensor:
    return torch.full_like(_f32(step), base_lr)
