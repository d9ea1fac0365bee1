"""Optimizers: AdamW, schedules, (pipelined) clipping, Krylov-Newton."""
from repro_torch.optim import adamw, clipping, schedules  # noqa: F401
