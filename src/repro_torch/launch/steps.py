"""Prefill and decode step factories.

The port of ``make_prefill_step`` / ``make_decode_step`` of the JAX
package's ``launch/steps.py``.  PyTorch runs eagerly, so a step is the
plain call under ``torch.inference_mode``; the mesh and sharding hints
come with ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, prefill


def make_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def serve_step(params, state, token):
        return decode_step(params, cfg, state, token)

    return serve_step
