"""Rank bodies of the sharded-model tests (spawned ranks import this
module: it imports no JAX).

:func:`sharded_jobs` runs a list of jobs on every rank of one spawn and
returns one record per job.  A job names a mesh by its ``model`` size
(``make_host_mesh``; every mesh is built once, in the order the jobs
first name it, the same on every rank), a config (:func:`config`'s
arguments; its ``sharding`` places the weights and splits the batch) and
one of these kinds:

- ``grads``: the loss, its metrics and the gradient blocks of one
  sharded ``loss_fn`` (remat "full") on the global batch, the weights
  carried across (``params``, a reference tree of numpy arrays) or drawn
  from seed 0 on the rank's device;
- ``step``: one sharded ``make_train_step`` from a numpy train state:
  the parameter and moment blocks after it and the metrics; a second
  step from a second copy of the state must give the same bits;
- ``train``: ``launch.train.train`` on the mesh with a checkpoint
  directory (restore, run, save): the losses;
- ``moe_ep``: ``moe_ffn_ep`` on this rank's rows of a numpy batch with
  numpy MoE weights: out, ``moe_aux``, ``moe_z`` and drops, and
  ``moe_ffn`` on the same rows;
- ``prefill``: a sharded ``make_prefill_step``: this rank's logits, the
  flash launches and the (B*H, S, D) shape of each;
- ``storage``: the bytes of this rank's stored parameter and moment
  blocks, and the bytes the specs say it holds;
- ``decode``: a sharded prefill of the first ``prompt`` tokens and
  ``sharding.decode_state`` (or, with no prompt,
  ``sharding.init_decode_state``), then ``steps`` sharded decode steps
  fed the next tokens: this rank's rows of each step's logits and its
  blocks of the last state;
- ``splits``: one sharded prefill and one decode step with the shapes
  recorded that attention, the weight blocks and the logits gather see,
  and the bytes of the parameter gathers the decode step made.

Each record carries the rank's mesh coordinates.
"""
import dataclasses
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import loss_fn


def config(arch, overrides=None, capacity=None, dtype="float32"):
    """The smoke config of ``arch`` in ``dtype`` with ``overrides``;
    ``capacity``: the MoE capacity factor ("no_drop": experts / top_k)."""
    cfg = dataclasses.replace(treg.smoke_config(arch), dtype=dtype,
                              **(overrides or {}))
    if capacity is not None and cfg.moe is not None:
        cf = (cfg.moe.num_experts / cfg.moe.top_k if capacity == "no_drop"
              else capacity)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _t(batch, device):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _model(job, cfg, mesh, device):
    """The job's weights carried across (``params``: a reference tree of
    numpy arrays) or drawn from seed 0, as this rank's blocks."""
    if "params" in job:
        return convert.sharded_params_from_numpy(cfg, job["params"], mesh,
                                                 device)
    return sharding.init_sharded_params(
        cfg, mesh, torch.Generator(device=device).manual_seed(0), device)


def _grads(job, mesh, device):
    cfg = config(**job["cfg"])
    model = _model(job, cfg, mesh, device)
    model.requires_grad_(True)
    named = sharding.stored(model)
    hints, batch = steps._hints_for(model, cfg, mesh,
                                    _t(job["batch"], device))
    loss, metrics = loss_fn(model, cfg, batch, remat="full", hints=hints)
    grads = torch.autograd.grad(loss, list(named.values()))
    return dict(loss=float(loss.detach()),
                metrics={k: float(torch.as_tensor(v).detach())
                         for k, v in metrics.items()},
                grads={k: _np(g) for k, g in zip(named, grads)},
                specs=sharding.specs_of(model))


def _step(job, mesh, device):
    cfg = config(**job["cfg"])
    tcfg = TrainConfig(**job["tcfg"])
    runs = []
    for _ in range(2):
        state = convert.sharded_train_state_from_numpy(
            cfg, job["state"], mesh, device)
        state, metrics = steps.make_train_step(cfg, tcfg, mesh)(
            state, _t(job["batch"], device))
        runs.append((state, metrics))
    (s0, m0), (s1, m1) = runs
    p0, p1 = sharding.stored(s0["params"]), sharding.stored(s1["params"])
    same = all(torch.equal(p0[k], p1[k]) for k in p0) and all(
        torch.equal(s0["opt"][w][k], s1["opt"][w][k])
        for w in ("m", "v") for k in p0) and all(
        torch.equal(m0[k], m1[k]) for k in m0)
    return dict(params={k: _np(v) for k, v in p0.items()},
                opt={w: {k: _np(v) for k, v in s0["opt"][w].items()}
                     for w in ("m", "v")},
                metrics={k: float(v) for k, v in m0.items()},
                specs=sharding.specs_of(s0["params"]), repeat_equal=same)


def _train(job, mesh, device):
    from repro_torch.launch.train import train
    cfg = config(**job["cfg"])
    tcfg = TrainConfig(**job["tcfg"])
    out = train(cfg, tcfg, mesh=mesh, log_every=0, device=device,
                **job.get("kw", {}))
    return dict(losses=out["losses"], steps=out["steps"])


def _moe_ep(job, mesh, device):
    from repro_torch.models.moe import MoE, moe_ffn
    from repro_torch.models.moe_ep import moe_ffn_ep
    from repro_torch.models.layers import Linear
    cfg = config(**job["cfg"])
    w = {k: torch.from_numpy(v).to(device) for k, v in job["moe"].items()}
    p = MoE(Linear(w["router"]), w["up"], w["down"], w.get("gate"))
    axes = sharding.fit_batch_axes(mesh, job["x"].shape[0],
                                   job.get("strategy", "2d"))
    x = sharding.shard_batch({"x": torch.from_numpy(job["x"]).to(device)},
                             mesh, axes)["x"]
    with torch.no_grad():
        out, aux = moe_ffn_ep(p, cfg, x, torch.float32, mesh, axes)
        ref, raux = moe_ffn(p, cfg, x, torch.float32)
    return dict(out=_np(out), aux={k: float(v) for k, v in aux.items()},
                gather_out=_np(ref),
                gather_aux={k: float(v) for k, v in raux.items()})


def _prefill(job, mesh, device):
    from repro_torch.kernels import ops
    cfg = config(**job["cfg"])
    model = _model(job, cfg, mesh, device)
    flash, shapes = ops.flash_mha, []

    def rec_flash(q, *a, **kw):       # the (B*H, S, D) the kernel gets
        shapes.append(tuple(q.shape))
        return flash(q, *a, **kw)

    ops.reset_launch_counts()
    ops.flash_mha = rec_flash
    try:
        logits, state = steps.make_prefill_step(cfg, mesh)(
            model, _t(job["batch"], device))
    finally:
        ops.flash_mha = flash
    return dict(logits=_np(logits), launches=ops.launch_counts(),
                rows=int(logits.shape[0]), flash_shapes=shapes)


def _storage(job, mesh, device):
    cfg = config(**job["cfg"])
    tcfg = TrainConfig(model=cfg.name)
    from repro_torch.launch.train import build_state
    state = build_state(cfg, tcfg, device=device, mesh=mesh)
    model = state["params"]
    held = sharding.tree_bytes(model) + sharding.tree_bytes(state["opt"])
    plan = sharding.share_bytes(model, state["opt"]["m"], state["opt"]["v"])
    return dict(held=held, plan=plan)


def _decode(job, mesh, device):
    cfg = config(**job["cfg"])
    model = _model(job, cfg, mesh, device)
    toks = torch.from_numpy(job["tokens"]).to(device)
    S, B = job["prompt"], toks.shape[0]
    logits = []
    if S:
        batch = {"tokens": toks[:, :S]}
        if cfg.frontend is not None:      # the zero stub serve feeds
            batch["frontend"] = torch.zeros(
                (B, cfg.frontend.num_positions, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        lg, state = steps.make_prefill_step(cfg, mesh)(model, batch)
        logits.append([_np(t) for t in lg] if isinstance(lg, tuple)
                      else _np(lg))
        state = sharding.decode_state(cfg, state, mesh, B, job["cache_len"])
    else:
        state = sharding.init_decode_state(cfg, mesh, B, job["cache_len"],
                                           device)
    step = steps.make_decode_step(cfg, mesh)
    for i in range(job["steps"]):
        state, lg = step(model, state, toks[:, S + i])
        logits.append([_np(t) for t in lg] if isinstance(lg, tuple)
                      else _np(lg))
    return dict(logits=logits, pos=state["pos"],
                state=[[_np(t) for t in st] for st in state["layers"]])


def _splits(job, mesh, device):
    from repro_torch.distributed import comm
    from repro_torch.models import attention
    cfg = config(**job["cfg"])
    model = _model(job, cfg, mesh, device)
    names = {id(m): n for n, m in model.named_modules()}
    seen = {"attend": [], "block": [], "logits": [], "gathered": 0}
    attend, block = attention.attend, sharding.MeshHints.block
    logits, gather = sharding.MeshHints.logits, sharding.Placed.gather

    def rec_attend(q, k, v, *a, **kw):
        seen["attend"].append((tuple(q.shape), tuple(k.shape)))
        return attend(q, k, v, *a, **kw)

    def rec_block(self, owner, attr, dim):
        t = block(self, owner, attr, dim)
        name = f"{names[id(owner)]}.{attr}".lstrip(".")
        seen["block"].append((name, tuple(t.shape)))
        return t

    def rec_logits(self, x):
        seen["logits"].append(tuple(x.shape))
        return logits(self, x)

    def rec_gather(self, blk, keep=()):
        b0 = comm.all_gather.bytes
        out = gather(self, blk, keep)
        seen["gathered"] += comm.all_gather.bytes - b0
        return out

    toks = torch.from_numpy(job["tokens"]).to(device)
    S, B = toks.shape[1] - 1, toks.shape[0]
    attention.attend = rec_attend
    sharding.MeshHints.block = rec_block
    sharding.MeshHints.logits = rec_logits
    try:
        _, state = steps.make_prefill_step(cfg, mesh)(
            model, {"tokens": toks[:, :S]})
        prefill = {k: seen[k] for k in ("attend", "block", "logits")}
        state = sharding.decode_state(cfg, state, mesh, B, job["cache_len"])
        seen.update(attend=[], block=[], logits=[])
        sharding.Placed.gather = rec_gather
        steps.make_decode_step(cfg, mesh)(model, state, toks[:, S])
    finally:
        attention.attend = attend
        sharding.MeshHints.block = block
        sharding.MeshHints.logits = logits
        sharding.Placed.gather = gather
    return dict(prefill=prefill, decode=seen)


KINDS = {"grads": _grads, "step": _step, "train": _train, "moe_ep": _moe_ep,
         "prefill": _prefill, "storage": _storage, "decode": _decode,
         "splits": _splits}


def sharded_jobs(rank, world, jobs, device="cpu"):
    meshes = {}
    out = []
    for job in jobs:
        n = job["model"]
        if n not in meshes:
            meshes[n] = make_host_mesh(n)
        mesh = meshes[n]
        t0 = time.perf_counter()
        rec = KINDS[job["kind"]](job, mesh, device)
        rec.update(coords=dict(mesh.coords), shape=dict(mesh.shape),
                   seconds=time.perf_counter() - t0)
        out.append(rec)
    return out


#: rows of 2 floats a message: one piece, several, a buffer grown past
#: MIN_BYTES, after a release
WIRE_ROWS = (3, 1000, 200000, 7)
WIRE_MAX_PIECES = 8      # a message of more pieces is left out


def card_wire_cases(rank, world, chunk_sizes, seed=5):
    """The card wire's protocol on host tensors (the "file_system"
    sharing strategy) against gloo on the same tensors, for each piece
    size of ``chunk_sizes``: gathers and sums on the whole group and on
    the lines of a (2, 2) mesh, messages of one piece and of several (up
    to ``WIRE_MAX_PIECES``), one that grows the buffers, and one after a
    release.  Returns {piece size: the largest gap of each kind} (0 where
    bit for bit)."""
    import torch.distributed as dist
    import torch.multiprocessing as tmp
    from repro_torch.distributed import card_wire, comm
    tmp.set_sharing_strategy("file_system")
    mesh = make_host_mesh(2)
    g = torch.Generator().manual_seed(seed + rank)
    out = {}
    for chunk_bytes in chunk_sizes:
        card_wire.CHUNK_BYTES = chunk_bytes
        wire = card_wire.attach(torch.device("cpu"))
        gaps = {"gather": 0.0, "sum": 0.0}
        try:
            for n in WIRE_ROWS:
                if -(-n * 8 // chunk_bytes) > WIRE_MAX_PIECES:
                    continue
                if n == WIRE_ROWS[-1]:
                    card_wire.release()
                for axes in (("data", "model"), ("data",), ("model",)):
                    group = mesh.group(axes)
                    size = mesh.count(axes)
                    x = torch.randn((n, 2), generator=g)
                    got = wire.all_gather(x, group)
                    want = [torch.empty_like(x) for _ in range(size)]
                    dist.all_gather(want, x, group=group)
                    gaps["gather"] = max(gaps["gather"], float(
                        (got - torch.stack(want)).abs().max()))
                    summed = want[0].clone()
                    for w in want[1:]:
                        summed += w             # group-rank order
                    gaps["sum"] = max(gaps["sum"], float(
                        (wire.all_reduce(x, group) - summed).abs().max()))
                    # the mesh helpers take the wire only for CUDA tensors
                    assert card_wire.for_tensor(x, group) is None
            assert comm.all_gather.bytes == 0
        finally:
            card_wire.detach()
        out[chunk_bytes] = gaps
    return out
