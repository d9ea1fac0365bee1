"""Train, prefill and decode step factories.

The port of ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` of the JAX package's ``launch/steps.py``.  PyTorch
runs eagerly, so a step is a plain call: prefill and decode under
``torch.inference_mode``, the train step under autograd.  The mesh and
sharding hints come with ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.transformer import decode_step, loss_fn, prefill
from repro_torch.optim import adamw, clipping, schedules


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``.

    ``state``: ``params`` (the LM, its parameters ``requires_grad``),
    ``opt`` (AdamW's m and v by parameter name), ``step`` and
    ``prev_gnorm`` (0-d tensors).  In order: loss and gradients, clipping
    (synchronous, delayed with the carried norm, or ``global_norm`` alone
    when ``grad_clip`` is 0), the schedule at ``step + 1``, AdamW in place.
    Metrics: ``loss``, ``ce``, ``moe_aux``, ``moe_z``, ``moe_dropped``,
    ``gnorm``, ``lr`` (detached 0-d tensors).
    """

    def train_step(state, batch):
        model = state["params"]
        named = dict(model.named_parameters())
        if not all(p.requires_grad for p in named.values()):
            raise ValueError("train_step: the parameters do not require "
                             "grad; build the state with "
                             "launch.train.build_state")
        loss, metrics = loss_fn(model, cfg, batch, remat=tcfg.remat)
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), materialize_grads=True)))

        if tcfg.grad_clip > 0:
            if tcfg.pipelined_clipping:
                grads, gnorm = clipping.clip_by_delayed_norm(
                    grads, state["prev_gnorm"], tcfg.grad_clip)
            else:
                grads, gnorm = clipping.clip_by_global_norm(grads,
                                                            tcfg.grad_clip)
        else:
            gnorm = clipping.global_norm(grads)

        step = state["step"] + 1
        lr = schedules.linear_warmup_cosine(
            step, base_lr=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
            total_steps=max(tcfg.steps, 1))
        adamw.update(grads, state["opt"], named, lr=lr,
                     weight_decay=tcfg.weight_decay, step=step)
        new_state = {"params": model, "opt": state["opt"], "step": step,
                     "prev_gnorm": gnorm.detach()}
        dev = loss.device
        out = {k: torch.as_tensor(v, device=dev).detach()
               for k, v in metrics.items()}
        out.update(loss=loss.detach(), gnorm=gnorm.detach(), lr=lr)
        return new_state, out

    return train_step


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
