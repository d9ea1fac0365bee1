"""End-to-end training: the entry point and its loop.

The port of the JAX package's ``launch/train.py``: any registry
architecture (full or smoke-reduced) with the synthetic data pipeline,
AdamW, (pipelined) clipping and asynchronous checkpoints with restart,
on one device or, with a ``mesh`` (``launch/mesh.py``), on the ranks of
a sharded model (``distributed/sharding.py``: every rank reads the same
global batches and computes on its rows).  Checkpoints hold whole
tensors, so a run restores on any mesh or on one device.  On the card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --steps 50 --checkpoint-dir /tmp/ckpt

(``--device cpu`` runs the plain versions on the host.)  The flash kernel
has no backward, so a config with ``attn_kernel=True`` is refused before
step 0, on any device.  Like the reference's, the loop ignores
``grad_compression`` and ``microbatch``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig, parse_overrides
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import sharding
from repro_torch.launch.serve import _sync
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw


def build_state(cfg: ModelConfig, tcfg: TrainConfig,
                generator: Optional[torch.Generator] = None,
                device="cuda", mesh=None) -> dict:
    """Parameters from ``generator`` (seed ``tcfg.seed`` if None), switched
    to ``requires_grad``, zero AdamW moments, step 0, prev_gnorm 0.  With
    a ``mesh``: the same parameters stored as this rank's blocks
    (``cfg.sharding``), the moments in their blocks' shapes."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    if mesh is None:
        params = init_params(cfg, generator, device)
    else:
        params = sharding.init_sharded_params(cfg, mesh, generator, device)
    params.requires_grad_(True)
    named = sharding.stored(params)
    return {"params": params,
            "opt": adamw.init(named, tcfg.optimizer_state_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "prev_gnorm": torch.zeros((), dtype=torch.float32,
                                      device=device)}


def checkpoint_tree(state: dict) -> dict:
    """The state as the nested dict of whole tensors a checkpoint stores
    (a sharded state's blocks gathered: a collective on every rank)."""
    model = state["params"]
    params = {k: p.detach() for k, p in sharding.stored(model).items()}
    opt = state["opt"]
    if sharding.is_sharded(model):
        params = sharding.whole(model, params)
        opt = {k: sharding.whole(model, t) for k, t in opt.items()}
    return {"params": params, "opt": opt, "step": state["step"],
            "prev_gnorm": state["prev_gnorm"]}


@torch.no_grad()
def load_tree(state: dict, tree: dict) -> dict:
    """``state`` with a restored :func:`checkpoint_tree` copied in (the
    parameters in place; a sharded state takes its blocks)."""
    model = state["params"]
    params, opt = tree["params"], tree["opt"]
    if sharding.is_sharded(model):
        params = sharding.blocks_of(model, params)
        opt = {k: sharding.blocks_of(model, t) for k, t in opt.items()}
    for k, p in sharding.stored(model).items():
        p.copy_(params[k])
    return {"params": model, "opt": opt,
            "step": tree["step"], "prev_gnorm": tree["prev_gnorm"]}


def train(cfg: ModelConfig, tcfg: TrainConfig, *, seq_len: int = 256,
          batch: int = 8, mesh=None, log_every: int = 10, progress=print,
          device="cuda") -> dict:
    """Train ``tcfg.steps`` steps from the latest checkpoint under
    ``tcfg.checkpoint_dir`` (or from scratch).  Returns the losses, each
    step's metrics (floats), the steps run, the seconds and each step's
    host seconds (to its metrics on the host), the final loss and the
    state.  With a ``mesh`` every rank of it calls ``train`` alike; the
    first rank writes the checkpoints."""
    if cfg.attn_kernel:
        raise ValueError(
            f"{cfg.name}: attn_kernel=True puts the flash kernel on the "
            "training path, and it has no backward (nor has the JAX "
            "package's Pallas kernel); train with attn_kernel=False")
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch,
        seed=tcfg.seed, num_codebooks=cfg.num_codebooks,
        frontend_positions=(cfg.frontend.num_positions if cfg.frontend
                            else 0),
        d_model=cfg.d_model), device=device)

    state = build_state(cfg, tcfg, device=device, mesh=mesh)
    writer = mesh is None or mesh.rank == 0
    step0 = 0
    mgr: Optional[CheckpointManager] = None
    if tcfg.checkpoint_dir:
        mgr = CheckpointManager(tcfg.checkpoint_dir)
        if mgr.latest_step() is not None:
            tree, manifest = mgr.restore(checkpoint_tree(state))
            state = load_tree(state, tree)
            step0 = int(manifest["step"])
            progress(f"[train] restored checkpoint at step {step0}")

    step_fn = make_train_step(cfg, tcfg, mesh)

    def save(step, loss):
        tree = checkpoint_tree(state)       # a collective under a mesh
        if writer:
            mgr.save(step, tree, {"loss": loss})

    losses, step_s, history = [], [], []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(step0, tcfg.steps):
        ts = time.perf_counter()
        state, metrics = step_fn(state, data.batch(i))
        history.append({k: float(v) for k, v in metrics.items()})
        losses.append(history[-1]["loss"])
        step_s.append(time.perf_counter() - ts)
        if log_every and (i % log_every == 0 or i == tcfg.steps - 1):
            progress(f"[train] step {i:5d} loss {losses[-1]:.4f} "
                     f"gnorm {history[-1]['gnorm']:.3f} "
                     f"lr {history[-1]['lr']:.2e}")
        if mgr and tcfg.checkpoint_every and \
                (i + 1) % tcfg.checkpoint_every == 0:
            save(i + 1, losses[-1])
    if mgr:
        save(tcfg.steps, losses[-1] if losses else float("nan"))
        mgr.wait()
        if mesh is not None and mesh.size > 1:
            torch.distributed.barrier()     # the files exist for every rank
    dt = time.perf_counter() - t0
    return {"losses": losses, "metrics": history,
            "steps": tcfg.steps - step0, "seconds": dt,
            "step_seconds": step_s,
            "final_loss": losses[-1] if losses else float("nan"),
            "state": state}


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--pipelined-clipping", action="store_true")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--overrides", default="",
                    help="ModelConfig overrides, e.g. ce_impl=onehot")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, **parse_overrides(args.overrides))
    tcfg = TrainConfig(model=cfg.name, steps=args.steps,
                       learning_rate=args.lr,
                       pipelined_clipping=args.pipelined_clipping,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every)
    out = train(cfg, tcfg, seq_len=args.seq_len, batch=args.batch,
                device=args.device)
    print(f"[train] done: {out['steps']} steps in {out['seconds']:.1f}s, "
          f"final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
