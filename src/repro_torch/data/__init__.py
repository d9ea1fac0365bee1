"""Deterministic synthetic data pipeline (resumable)."""
from repro_torch.data.synthetic import DataConfig, SyntheticTokens  # noqa: F401
