"""Checkpoint/restart: async, atomic, independent of the process group."""
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: F401
