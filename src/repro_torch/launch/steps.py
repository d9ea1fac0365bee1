"""Train, prefill and decode step factories, and abstract input trees.

The port of the JAX package's ``launch/steps.py``.  PyTorch runs
eagerly, so a step is a plain call: prefill and decode under
``torch.inference_mode``, the train step under autograd.  With a
``mesh`` the steps run on the ranks of a sharded model
(``distributed/sharding.py``): each takes the global batch and computes
on this rank's rows of it.

Abstract trees are meta-device tensors (no storage: the full-scale configs
are never allocated), paired with their specs by :func:`shard_tree`.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed import comm, sharding
from repro_torch.models.transformer import (decode_step, init_decode_state,
                                            init_params, loss_fn, prefill)
from repro_torch.optim import adamw, clipping, schedules

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Abstract trees
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig):
    """The model on the meta device (shapes and dtypes, no storage)."""
    return init_params(cfg, torch.Generator(), META)


def abstract_opt_state(cfg: ModelConfig, tcfg: TrainConfig):
    return adamw.init(sharding.stored(abstract_params(cfg)),
                      tcfg.optimizer_state_dtype)


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig):
    return {"params": abstract_params(cfg),
            "opt": abstract_opt_state(cfg, tcfg),
            "step": torch.zeros((), dtype=torch.int32, device=META),
            "prev_gnorm": torch.zeros((), dtype=torch.float32, device=META)}


def abstract_decode_state(cfg: ModelConfig, batch: int, cache_len: int):
    return init_decode_state(cfg, batch, cache_len, device=META)


class Sharded(NamedTuple):
    """An abstract array with the spec it is laid out by."""

    shape: tuple
    dtype: torch.dtype
    spec: Optional[sharding.P]


def _sds(shape, dtype, mesh=None, spec=None) -> Sharded:
    return Sharded(tuple(shape), dtype, spec if mesh is not None else None)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None
                ) -> Dict[str, Any]:
    """Stand-ins for the data batch of one step."""
    B, S = shape.global_batch, shape.seq_len
    F = cfg.frontend.num_positions if cfg.frontend is not None else 0
    n = S - F
    bspec = (sharding.fit_batch_spec(mesh, B, cfg.sharding)
             if mesh is not None else None)
    P = sharding.P

    if shape.kind in ("train", "prefill"):
        tok_shape = (B, n, cfg.num_codebooks) if cfg.num_codebooks > 1 \
            else (B, n)
        tok_spec = P(*([bspec] + [None] * (len(tok_shape) - 1)))
        specs = {"tokens": _sds(tok_shape, torch.int32, mesh, tok_spec)}
        if F:
            specs["frontend"] = _sds((B, F, cfg.d_model), torch.bfloat16,
                                     mesh, P(bspec, None, None))
        if shape.kind == "train":
            specs["labels"] = _sds(tok_shape, torch.int32, mesh, tok_spec)
        return specs

    # decode: one new token with a cache of S
    tok_shape = (B, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B,)
    return {"token": _sds(tok_shape, torch.int32, mesh,
                          P(*([bspec] + [None] * (len(tok_shape) - 1))))}


def shard_tree(abstract_tree, spec_tree, mesh=None):
    """Pair each leaf of an abstract tree (tensors, nested dicts, lists or
    NamedTuples) with the spec at the same place of ``spec_tree``."""
    if isinstance(abstract_tree, torch.Tensor) or isinstance(
            abstract_tree, Sharded):
        return Sharded(tuple(abstract_tree.shape), abstract_tree.dtype,
                       spec_tree)
    if isinstance(abstract_tree, dict):
        return {k: shard_tree(v, spec_tree[k], mesh)
                for k, v in abstract_tree.items()}
    if isinstance(abstract_tree, tuple) and hasattr(abstract_tree,
                                                    "_fields"):
        return type(abstract_tree)(*(shard_tree(v, s, mesh) for v, s in
                                     zip(abstract_tree, spec_tree)))
    if isinstance(abstract_tree, (list, tuple)):
        return type(abstract_tree)(shard_tree(v, s, mesh) for v, s in
                                   zip(abstract_tree, spec_tree))
    return Sharded((), type(abstract_tree), spec_tree)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _hints_for(model, cfg: ModelConfig, mesh, batch, strategy=None):
    """MeshHints bound to ``batch``'s rows (split as ``strategy`` says,
    default ``cfg.sharding``), the model's gathers told the batch axes,
    and this rank's rows of the batch."""
    if model.shard_plan.strategy != cfg.sharding:
        raise ValueError(
            f"the parameters are placed for {model.shard_plan.strategy!r} "
            f"and the step splits the batch for {cfg.sharding!r}: place "
            "them with the config the step is made from")
    hints = sharding.MeshHints(mesh, cfg.sharding)
    axes = hints.bind(batch["tokens"].shape[0], strategy)
    model.shard_plan.batch_axes = axes
    return hints, sharding.shard_batch(batch, mesh, axes)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``.

    ``state``: ``params`` (the LM, its parameters ``requires_grad``),
    ``opt`` (AdamW's m and v by parameter name), ``step`` and
    ``prev_gnorm`` (0-d tensors).  In order: loss and gradients, clipping
    (synchronous, delayed with the carried norm, or ``global_norm`` alone
    when ``grad_clip`` is 0), the schedule at ``step + 1``, AdamW in place.
    Metrics: ``loss``, ``ce``, ``moe_aux``, ``moe_z``, ``moe_dropped``,
    ``gnorm``, ``lr`` (detached 0-d tensors).

    With a ``mesh`` the state is sharded (``sharding.shard_state``): the
    step takes the global batch, computes on this rank's rows, and the
    gradients, moments and AdamW are this rank's blocks; the loss is the
    global batch's, and the norm counts each element of the whole
    gradient once.
    """

    def train_step(state, batch):
        model = state["params"]
        named = sharding.stored(model)
        if not all(p.requires_grad for p in named.values()):
            raise ValueError("train_step: the parameters do not require "
                             "grad; build the state with "
                             "launch.train.build_state")
        kw = {"remat": tcfg.remat}
        norm = None
        if mesh is not None:
            kw["hints"], batch = _hints_for(model, cfg, mesh, batch)
        loss, metrics = loss_fn(model, cfg, batch, **kw)
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), materialize_grads=True)))
        if mesh is not None:
            norm = sharding.global_norm(grads, model)
        new_state, gnorm, lr = apply_gradients(state, grads, tcfg, norm)
        dev = loss.device
        out = {k: torch.as_tensor(v, device=dev).detach()
               for k, v in metrics.items()}
        out.update(loss=loss.detach(), gnorm=gnorm.detach(), lr=lr)
        return new_state, out

    return train_step


def apply_gradients(state, grads: Dict[str, torch.Tensor], tcfg: TrainConfig,
                    norm: Optional[torch.Tensor] = None):
    """The rest of a train step once its gradients (by parameter name) are
    known: clipping (synchronous, delayed with the carried norm, or the
    global norm alone when ``grad_clip`` is 0), the schedule at ``step +
    1``, AdamW in place.  ``norm``: the gradient norm where the caller
    computed it (a sharded model's, each element counted once).  Returns
    the new state, the norm and the learning rate."""
    if tcfg.grad_clip > 0:
        if tcfg.pipelined_clipping:
            grads, gnorm = clipping.clip_by_delayed_norm(
                grads, state["prev_gnorm"], tcfg.grad_clip, norm=norm)
        else:
            grads, gnorm = clipping.clip_by_global_norm(
                grads, tcfg.grad_clip, norm=norm)
    else:
        gnorm = clipping.global_norm(grads) if norm is None else norm

    step = state["step"] + 1
    lr = schedules.linear_warmup_cosine(
        step, base_lr=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
        total_steps=max(tcfg.steps, 1))
    adamw.update(grads, state["opt"], sharding.stored(state["params"]),
                 lr=lr, weight_decay=tcfg.weight_decay, step=step)
    return ({"params": state["params"], "opt": state["opt"], "step": step,
             "prev_gnorm": gnorm.detach()}, gnorm, lr)


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch) -> (logits, state)``; with a ``mesh``
    the logits and state are this rank's rows of the batch's (the KV
    caches this rank's KV heads where the heads split over ``model``):
    ``sharding.decode_state`` turns the state into the decode state's
    blocks."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        if mesh is None:
            return prefill(params, cfg, batch)
        hints, batch = _hints_for(params, cfg, mesh, batch)
        return prefill(params, cfg, batch, hints=hints)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, state, token) -> (state, logits)``.

    With a ``mesh``: ``state`` is this rank's blocks of the decode state
    (STATE_RULES: ``sharding.init_decode_state``, or
    ``sharding.decode_state`` after a sharded prefill), ``token`` the
    global batch's (B[, ncb]).  The step computes on STATE_RULES' rows
    (the "2d" batch split, under either strategy: "fsdp" splits no
    compute, so a model line decodes its data shard's rows together) and
    returns this rank's rows of the logits, as ``make_prefill_step``
    does."""

    @torch.inference_mode()
    def serve_step(params, state, token):
        if mesh is None:
            return decode_step(params, cfg, state, token)
        B = token.shape[0]
        hints, batch = _hints_for(params, cfg, mesh, {"tokens": token}, "2d")
        state, logits = decode_step(params, cfg, state, batch["tokens"],
                                    hints=hints)
        extra = tuple(a for a in sharding.fit_batch_axes(mesh, B,
                                                         cfg.sharding)
                      if a not in hints.batch_axes)

        def own(t):
            return comm.own_block(t, 0, mesh, extra) if extra else t

        if isinstance(logits, tuple):
            return state, tuple(own(t) for t in logits)
        return state, own(logits)

    return serve_step


def dryrun_lowerable(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
                     mesh):
    raise NotImplementedError(
        "the dry run (launch/dryrun.py, launch/hlo_analysis.py) is the last "
        "slice of ROADMAP.md queue 1 item 8")
