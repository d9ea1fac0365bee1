"""Sharded models on the port's ranks against the JAX package, on the CPU.

One spawn of 4 gloo CPU ranks (``ranks.run``, the rank body
tests/torch_sharded_ranks.py) runs every case on the meshes (2, 2),
(1, 4) and (4, 1) of those ranks; the JAX references are computed in
this process while the ranks run.  Both packages get the same weights
(the JAX ``init_params`` tree) and the same numpy batch (4 x 16 with a
mask), float32 compute.  The cases are chosen to keep the file within a
minute: each gloo collective between processes costs milliseconds, and a
step issues one a parameter each way.



(a) The sharded loss, its metrics and every rank's gradient blocks of the
    qwen3, recurrentgemma and olmoe smoke configs (olmoe with
    ``moe_impl`` "gather" and "ep", at the capacity that drops nothing),
    each config under "2d" and "fsdp" on one or more of the three meshes
    (``GRADS``; ``GRADS_SPLIT``: heads and KV heads split over ``model``,
    q's rows split, the expert route under "fsdp"), held to the JAX
    package's unsharded
    ``loss_fn`` / ``jax.value_and_grad`` within
    tests/test_torch_train.py's ``LOSS_TOL`` / ``LEAF_RTOL``.  The (1, 4)
    mesh under "2d" puts four ranks on one batch block: a gradient summed
    over ``model`` would read four times too large.  The expert route
    averages ``moe_aux`` over the data shards (the reference EP's own
    definition), so its reference is the JAX package's EP body
    ``_ep_local`` run under nested ``jax.vmap`` with the axis names
    ``data`` and ``model`` in place of ``moe_ffn_ep``'s ``shard_map``;
    with one data shard that is the unsharded model.
(b) One sharded AdamW step from a state with random moments and a carried
    norm that clips, held to the reference's train-step body
    (tests/test_torch_train.py::_jax_step, itself held to the jitted JAX
    ``make_train_step`` there); a second step from a copy of the state
    repeats every block bit for bit.
(c) ``moe_ffn_ep`` against ``_ep_local`` under ``jax.vmap`` (out,
    ``moe_aux``, ``moe_z``) at a capacity that drops, on (2, 2) and
    (1, 4), and against the port's ``moe_ffn`` on the same rows at the
    capacity that drops nothing.
(d) A checkpoint moves between meshes and one device: one step on one
    device -> one on (2, 2) -> one on (4, 1) -> one on one device, each
    run restoring the checkpoint the run before it saved, within 1e-4 of
    the uninterrupted one-device run's losses (the schedule stays in its
    warm-up, where a run's step count does not change it).
(e) A sharded prefill's rows of the logits against the one-device
    prefill; the bytes every rank stores against its share of the plan.
(f) Placement and the step read one strategy, ``cfg.sharding``: a step
    refuses parameters placed for another.
(g) Decode under a mesh (``DECODE``): a sharded prefill,
    ``sharding.decode_state`` and 3 sharded decode steps of qwen3,
    recurrentgemma, olmoe ("fsdp" + "ep"), rwkv6 and musicgen on the
    three meshes, heads split and not: every step's logits and each
    rank's STATE_RULES blocks of the last state against the JAX
    package's unsharded ``prefill`` / ``decode_step`` within
    tests/test_torch_lm.py's float32 bar (2e-5); a ring from
    ``sharding.init_decode_state`` whose ``pos`` wraps past the window.
(h) What each rank computes under "2d" (the shapes attention, the
    weight blocks and the logits gather see; no parameter gathered in a
    decode step on (1, 4)), and ``moe_ffn_ep`` with the batch split over
    both axes ("fsdp") against ``_ep_local`` under ``jax.vmap``.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as tsr
from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch.serve import prefill_to_decode_state as j_prefill_to_decode
from repro.models import moe_ep as jmoe_ep
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs.base import ATTN_LOCAL, TrainConfig
from repro_torch.distributed import comm, ranks
from repro_torch.distributed.sharding import (fit_batch_axes, model_blocks,
                                              split_dims)
from repro_torch.models.attention import decode_cache
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import train
from test_torch_train import (GLOBAL_FLOOR, LEAF_RTOL, LOSS_TOL, _jax_step,
                              _tcfg)

B, S = 4, 16
WORLD = 4
MESHES = ((2, 2), (1, 4), (4, 1))
#: (arch, moe_impl, strategy, mesh): every config, strategy and mesh at
#: least once; "2d" on (1, 4) puts all four ranks on one batch block
HEADS = (("shard_attn_heads", True),)
#: H = 6 does not divide over model = 4: q's rows split (sequence-parallel)
SEQ = HEADS + (("num_heads", 6),)
GRADS = (("qwen3-1.7b", "gather", "2d", (2, 2)),
         ("qwen3-1.7b", "gather", "2d", (1, 4)),
         ("qwen3-1.7b", "gather", "fsdp", (2, 2)),
         ("qwen3-1.7b", "gather", "fsdp", (4, 1)),
         ("recurrentgemma-2b", "gather", "2d", (4, 1)),
         ("recurrentgemma-2b", "gather", "fsdp", (1, 4)),
         ("olmoe-1b-7b", "gather", "2d", (2, 2)),
         ("olmoe-1b-7b", "gather", "fsdp", (1, 4)),
         ("olmoe-1b-7b", "ep", "2d", (2, 2)),
         ("olmoe-1b-7b", "ep", "2d", (1, 4)))
#: the same with config overrides: heads (and KV heads on (2, 2)) split
#: over model, q's rows split, the expert route under "fsdp"
GRADS_SPLIT = (("qwen3-1.7b", "gather", "2d", (2, 2), HEADS),
               ("qwen3-1.7b", "gather", "2d", (1, 4), HEADS),
               ("recurrentgemma-2b", "gather", "2d", (1, 4), SEQ),
               ("olmoe-1b-7b", "ep", "fsdp", (2, 2), ()))
GRADS_ALL = tuple(g + ((),) for g in GRADS) + GRADS_SPLIT


def _grads_id(i):
    arch, impl, strategy, _, ov = GRADS_ALL[i]
    tag = "".join(f"-{k}" for k, _ in ov if k != "shard_attn_heads")
    heads = "-heads" if dict(ov).get("shard_attn_heads") else ""
    return f"{arch}-{impl}-{strategy}-mesh{i}" + heads + tag.replace(
        "-num_heads", "-seq")
#: (arch, moe_impl, strategy, mesh, pipelined clipping, moment dtype)
STEPS = (("qwen3-1.7b", "gather", "2d", (2, 2), False, "float32"),
         ("qwen3-1.7b", "gather", "fsdp", (1, 4), True, "bfloat16"),
         ("olmoe-1b-7b", "ep", "2d", (2, 2), True, "float32"))
EP_MESHES = ((2, 2), (1, 4))
EP_DROP = 0.5                # capacity factor: drops on both meshes
CKPT_STEPS, CKPT_TOL = 4, 1e-4   # one step a run; losses vs one device
#: warm-up past the last step: the schedule does not read a run's steps
CKPT_WARMUP = 10
PREFILL = (("olmoe-1b-7b", "ep", "2d", (2, 2)),
           ("qwen3-1.7b", "gather", "fsdp", (4, 1)))
#: (arch, moe_impl, strategy, mesh, overrides): a sharded prefill of
#: DEC_PROMPT tokens, ``sharding.decode_state``, DEC_STEPS decode steps;
#: every config, mesh and strategy, heads split and not
DECODE = (("qwen3-1.7b", "gather", "2d", (2, 2), ()),
          ("qwen3-1.7b", "gather", "2d", (2, 2), HEADS),
          ("qwen3-1.7b", "gather", "2d", (1, 4), HEADS),
          ("qwen3-1.7b", "gather", "2d", (4, 1), HEADS),
          ("qwen3-1.7b", "gather", "fsdp", (2, 2), HEADS),
          ("recurrentgemma-2b", "gather", "2d", (1, 4), HEADS),
          ("recurrentgemma-2b", "gather", "2d", (1, 4), SEQ),
          ("recurrentgemma-2b", "gather", "2d", (2, 2), ()),
          ("olmoe-1b-7b", "ep", "fsdp", (2, 2), HEADS),
          ("olmoe-1b-7b", "ep", "fsdp", (1, 4), ()),
          ("olmoe-1b-7b", "ep", "fsdp", (4, 1), ()),
          ("olmoe-1b-7b", "ep", "2d", (1, 4), HEADS),
          ("rwkv6-7b", "gather", "2d", (1, 4), ()),
          ("rwkv6-7b", "gather", "2d", (2, 2), HEADS),
          ("rwkv6-7b", "gather", "fsdp", (4, 1), ()),
          ("musicgen-medium", "gather", "2d", (1, 4), HEADS))
DEC_PROMPT, DEC_STEPS = S, 3
#: decode from ``sharding.init_decode_state``: the ring of the smoke
#: window (8 slots, 2 a rank) wraps past it
ROLLING = ("recurrentgemma-2b", "gather", "2d", (1, 4), HEADS)
ROLL_STEPS, ROLL_CACHE = 12, 16
#: tests/test_torch_lm.py's float32 bar of decode against the reference
DEC_TOL = 2e-5
#: moe_ffn_ep with the batch split over data and model ("fsdp")
EP_FSDP_MESHES = ((2, 2), (1, 4))
SPLITS = ((2, 2), (1, 4))


def _f32():
    """x64 off (tests/conftest.py turns it on), a context of its own: the
    references compile in threads side by side."""
    return jax.enable_x64(False)


def _cfg_kw(arch, impl, strategy="2d", ov=()):
    """A smoke config's arguments; ``strategy`` is its ``sharding``, which
    both places the weights and splits the batch; ``ov``: more fields."""
    return dict(arch=arch, overrides={"moe_impl": impl, "sharding": strategy,
                                      **dict(ov)},
                capacity="no_drop")


def _shape_ov(ov):
    """The overrides that change the model itself (not its sharding)."""
    return tuple((k, v) for k, v in ov if k == "num_heads")


def _jcfg(arch, ov=()):
    cfg = dataclasses.replace(jreg.smoke_config(arch), dtype="float32",
                              **dict(_shape_ov(ov)))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=3):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, 256, (B, S)).astype(np.int32),
            "labels": g.integers(0, 256, (B, S)).astype(np.int32),
            "mask": (g.random((B, S)) < 0.8).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _params(arch, ov=()):
    jc = _jcfg(arch, ov)
    with _f32():
        return _np(jax.jit(lambda: jtf.init_params(
            jc, jax.random.PRNGKey(0)))())


class _EPHints(jtf.Hints):
    def __init__(self, data, model):
        self.mesh = type("FakeMesh", (), dict(
            axis_names=("data", "model"),
            shape={"data": data, "model": model}))()


def _vmapped_ep(p, cfg, x, dtype, mesh):
    """The reference's ``moe_ffn_ep`` with its ``shard_map`` replaced by
    nested ``jax.vmap`` over ``data`` (rows) and ``model`` (experts)
    around the same ``_ep_local`` body."""
    D, M = mesh.shape["data"], mesh.shape["model"]
    Bx, Sx, d = x.shape
    E = cfg.moe.num_experts
    gate = p.get("gate")

    def split(w):
        return None if w is None else w.reshape((M, E // M) + w.shape[1:])

    def body(xl, up, g, down):
        return jmoe_ep._ep_local(xl, p["router"]["w"], up, g, down, cfg=cfg,
                                 model_axis="model", batch_axes=("data",),
                                 dtype=dtype)

    f = jax.vmap(body, in_axes=(None, 0, None if gate is None else 0, 0),
                 axis_name="model")
    f = jax.vmap(f, in_axes=(0, None, None, None), axis_name="data")
    out, aux, z = f(x.reshape((D, Bx // D, Sx, d)), split(p["up"]),
                    split(gate), split(p["down"]))
    return out[:, 0].reshape(Bx, Sx, d), {"moe_aux": aux[0, 0],
                                          "moe_z": z[0, 0]}


@functools.lru_cache(maxsize=None)
def _reference(arch, impl, data=1, model=1, ov=()):
    """Loss, metrics and gradients of the JAX ``loss_fn`` (jitted):
    unsharded, or with the vmapped EP body on ``data`` x ``model``."""
    jc = _jcfg(arch, ov)
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    hints = jtf.Hints()
    if impl == "ep" and data > 1:
        jc = dataclasses.replace(jc, moe_impl="ep")
        hints = _EPHints(data, model)
    with _f32(), mock.patch.object(jmoe_ep, "moe_ffn_ep", _vmapped_ep):
        vg = jax.jit(jax.value_and_grad(
            lambda p, bb: jtf.loss_fn(p, jc, bb, remat="none", hints=hints),
            has_aux=True))
        (loss, metrics), grads = vg(jax.tree.map(jnp.asarray,
                                                 _params(arch, ov)), b)
    return float(loss), _np(metrics), _np(grads)


def _by_name(arch, tree, ov=()) -> dict:
    """A params-shaped numpy tree as {port name: float32 numpy}."""
    cfg = tsr.config(arch, dict(_shape_ov(ov)))
    from repro_torch.convert import lm_params_from_numpy
    return {k: p.detach().float().numpy() for k, p in
            lm_params_from_numpy(cfg, tree, "cpu").named_parameters()}


def _block(full, spec, rec):
    """The block of ``full`` that the rank of ``rec`` holds under
    ``spec``."""
    shape, coords = rec["shape"], rec["coords"]
    rank = 0
    for a in shape:
        rank = rank * shape[a] + coords[a]
    mesh = Mesh(shape, rank)
    t = torch.from_numpy(np.ascontiguousarray(full))
    for dim, axes in split_dims(spec):
        t = comm.own_block(t, dim, mesh, axes)
    return t.numpy()


def _worst(got: dict, want: dict, specs: dict, rec, leaf_rtol=LEAF_RTOL,
           floor=GLOBAL_FLOOR) -> float:
    """max over leaves of max |block - reference block| over the bar of
    tests/test_torch_train.py (the whole leaf's max |g|)."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        bar = leaf_rtol * float(np.abs(w).max()) + floor * top
        gap = float(np.abs(got[k] - _block(w, specs[k], rec)).max())
        worst = max(worst, gap / bar if bar else (0.0 if gap == 0 else
                                                  float("inf")))
    return worst


def _step_state(arch, dtype, rms=1e-2, seed=11):
    """test_torch_train.py's state (moments drawn at a gradient scale, v
    bounded away from eps, step 3, a carried norm of 2 that clips) at a
    fixed scale ``rms``."""
    g = np.random.default_rng(seed)
    params = _params(arch)
    m = jax.tree.map(lambda p: (rms * g.standard_normal(p.shape))
                     .astype(np.float32), params)
    v = jax.tree.map(lambda p: (rms ** 2 * (0.5 + g.random(p.shape)))
                     .astype(np.float32), params)
    with _f32():
        m, v = (_np(jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), t))
                for t in (m, v))
    return {"params": params, "opt": {"m": m, "v": v},
            "step": np.int32(3), "prev_gnorm": np.float32(2.0)}


def _dec_tokens(seed=9, n=DEC_PROMPT + DEC_STEPS, ncb=1):
    shape = (B, n) + ((ncb,) if ncb > 1 else ())
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _dec_cache(arch, prompt=DEC_PROMPT, steps=DEC_STEPS):
    """Frontend positions, prompt and steps, rounded up to split over 4."""
    cfg = tsr.config(arch)
    F = cfg.frontend.num_positions if cfg.frontend is not None else 0
    return -(-(F + prompt + steps) // 4) * 4


def _jobs(ckpt):
    jobs = []
    for i, (arch, impl, strategy, mesh, ov) in enumerate(GRADS_ALL):
        jobs.append(dict(kind="grads", model=mesh[1], case=i,
                         cfg=_cfg_kw(arch, impl, strategy, ov),
                         params=_params(arch, _shape_ov(ov)),
                         batch=_batch()))
    for arch, impl, strategy, mesh, pipelined, dtype in STEPS:
        jobs.append(dict(kind="step", model=mesh[1],
                         cfg=_cfg_kw(arch, impl, strategy),
                         tcfg=vars(_tcfg(TrainConfig, pipelined, dtype,
                                         arch)),
                         state=_step_state(arch, dtype), batch=_batch()))
    g = np.random.default_rng(7)
    jc = _jcfg("olmoe-1b-7b")
    m = jc.moe
    moe = {"router": (g.standard_normal((jc.d_model, m.num_experts)) * 0.5),
           "up": g.standard_normal((m.num_experts, jc.d_model, m.d_ff)) * 0.1,
           "gate": g.standard_normal((m.num_experts, jc.d_model, m.d_ff))
           * 0.1,
           "down": g.standard_normal((m.num_experts, m.d_ff, jc.d_model))
           * 0.1}
    moe = {k: v.astype(np.float32) for k, v in moe.items()}
    x = g.standard_normal((B, S, jc.d_model)).astype(np.float32)
    for mesh in EP_MESHES:
        for cap in (EP_DROP, "no_drop"):
            jobs.append(dict(kind="moe_ep", model=mesh[1], moe=moe, x=x,
                             cfg=dict(arch="olmoe-1b-7b", capacity=cap)))
    for mesh in EP_FSDP_MESHES:
        jobs.append(dict(kind="moe_ep", model=mesh[1], moe=moe, x=x,
                         strategy="fsdp",
                         cfg=dict(arch="olmoe-1b-7b", capacity=EP_DROP)))
    for mesh, end in (((2, 2), 2), ((4, 1), 3)):
        jobs.append(dict(kind="train", model=mesh[1],
                         kw=dict(seq_len=S, batch=B),
                         cfg=dict(arch="qwen3-1.7b"),
                         tcfg=vars(_ckpt_tcfg(end, ckpt))))
    for arch, impl, strategy, mesh in PREFILL:
        jobs.append(dict(kind="prefill", model=mesh[1],
                         cfg=_cfg_kw(arch, impl, strategy),
                         params=_params(arch),
                         batch={k: v for k, v in _batch().items()
                                if k == "tokens"}))
    for arch, impl, mesh in (("qwen3-1.7b", "gather", (2, 2)),
                             ("olmoe-1b-7b", "ep", (2, 2)),
                             ("recurrentgemma-2b", "gather", (4, 1))):
        jobs.append(dict(kind="storage", model=mesh[1],
                         cfg=_cfg_kw(arch, impl)))
    for i, (arch, impl, strategy, mesh, ov) in enumerate(DECODE):
        jobs.append(dict(kind="decode", model=mesh[1], case=i,
                         cfg=_cfg_kw(arch, impl, strategy, ov),
                         params=_params(arch, _shape_ov(ov)),
                         tokens=_dec_tokens(
                             ncb=tsr.config(arch).num_codebooks),
                         prompt=DEC_PROMPT, steps=DEC_STEPS,
                         cache_len=_dec_cache(arch)))
    arch, impl, strategy, mesh, ov = ROLLING
    jobs.append(dict(kind="decode", model=mesh[1], case="rolling",
                     cfg=_cfg_kw(arch, impl, strategy, ov),
                     params=_params(arch, _shape_ov(ov)),
                     tokens=_dec_tokens(n=ROLL_STEPS), prompt=0,
                     steps=ROLL_STEPS, cache_len=ROLL_CACHE))
    for mesh in SPLITS:
        jobs.append(dict(kind="splits", model=mesh[1],
                         cfg=_cfg_kw("qwen3-1.7b", "gather", "2d", HEADS),
                         params=_params("qwen3-1.7b"),
                         tokens=_dec_tokens(n=DEC_PROMPT + 1),
                         cache_len=_dec_cache("qwen3-1.7b")))
    return jobs


def _ckpt_tcfg(steps_, directory=""):
    return TrainConfig(model="qwen3-1.7b", steps=steps_,
                       warmup_steps=CKPT_WARMUP, learning_rate=1e-2,
                       checkpoint_dir=str(directory))


def _one_device(steps_, directory=""):
    return train(tsr.config("qwen3-1.7b"), _ckpt_tcfg(steps_, directory),
                 seq_len=S, batch=B, log_every=0, device="cpu")["losses"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Run the jobs on the ranks, compute every JAX reference, and return
    both with the jobs and the one-device runs of the checkpoint chain:
    an uninterrupted run of ``CKPT_STEPS``, then one step on one device ->
    one on (2, 2) -> one on (4, 1) -> one on one device, each run
    restoring the checkpoint the run before it saved at its end."""
    ckpt = tmp_path_factory.mktemp("sharded") / "ckpt"
    whole = _one_device(CKPT_STEPS)
    first = _one_device(1, ckpt)
    jobs = _jobs(ckpt)
    spawned = ranks.start(tsr.sharded_jobs, WORLD, jobs, "cpu",
                          device="cpu")
    try:
        # the references compile side by side while the ranks start up;
        # the steps' references read the gradients' from the cache
        keys = sorted({_ref_key(a, i, *m, ov) for a, i, _, m, ov in GRADS_ALL})
        dec = sorted({(a, _shape_ov(ov), DEC_PROMPT, DEC_STEPS,
                       _dec_cache(a)) for a, _, _, _, ov in DECODE}
                     | {(ROLLING[0], (), 0, ROLL_STEPS, ROLL_CACHE)})
        with ThreadPoolExecutor(len(keys) + len(dec)) as pool:
            decs = [pool.submit(_reference_decode, *k) for k in dec]
            refs = dict(zip(keys, pool.map(lambda k: _reference(*k), keys)))
            for w in decs:
                w.result()
        with ThreadPoolExecutor(len(STEPS) + len(EP_MESHES)) as pool:
            waits = [pool.submit(_reference_step, a, i, *m, pl, dt)
                     for a, i, _, m, pl, dt in STEPS]
            eps = [pool.submit(_ep_local_reference, job,
                               WORLD // job["model"], job["model"])
                   for job in jobs if job["kind"] == "moe_ep"]
            for w in waits:
                w.result()
            ep_refs = [w.result() for w in eps]
        out = spawned.result()
    except BaseException:
        spawned.cancel()
        raise
    last = _one_device(CKPT_STEPS, ckpt)
    return dict(jobs=jobs, out=out, refs=refs, whole=whole, ep_refs=ep_refs,
                chain=first + [None, None] + last)


def _ref_key(arch, impl, data, model, ov=()):
    """The reference of a case: the vmapped EP body on data x model for
    the expert route over more than one data shard, else unsharded."""
    ep = impl == "ep" and data > 1
    return (arch, impl, data if ep else 1, model if ep else 1, _shape_ov(ov))


def _records(run, kind):
    """[(job, [record of each rank])] of one kind of job."""
    return [(job, [run["out"][r][i] for r in range(WORLD)])
            for i, job in enumerate(run["jobs"]) if job["kind"] == kind]


def _case(run, kind, case):
    """The records of the job of ``kind`` with ``case``."""
    (_, recs), = [(j, r) for j, r in _records(run, kind)
                  if j.get("case") == case]
    return recs


@pytest.mark.parametrize("arch,impl,strategy,mesh,ov", [
    pytest.param(*g, id=_grads_id(i)) for i, g in enumerate(GRADS_ALL)])
def test_sharded_loss_and_grad_blocks_match_the_reference(run, arch, impl,
                                                          strategy, mesh,
                                                          ov):
    recs = _case(run, "grads", GRADS_ALL.index((arch, impl, strategy, mesh,
                                                ov)))
    key = _ref_key(arch, impl, *mesh, ov)
    jloss, jmetrics, jgrads = run["refs"][key]
    want = _by_name(arch, jgrads, ov)
    for rec in recs:
        assert rec["shape"] == {"data": mesh[0], "model": mesh[1]}
        assert abs(rec["loss"] - jloss) <= LOSS_TOL
        assert abs(rec["metrics"]["ce"] - float(jmetrics["ce"])) <= LOSS_TOL
        for k in ("moe_aux", "moe_z"):
            assert abs(rec["metrics"][k] - float(jmetrics[k])) <= LOSS_TOL
        assert rec["metrics"]["moe_dropped"] == 0
        assert _worst(rec["grads"], want, rec["specs"], rec) <= 1.0


@functools.lru_cache(maxsize=None)
def _reference_step(arch, impl, data, model, pipelined, dtype):
    jloss, _, jgrads = _reference(*_ref_key(arch, impl, data, model))
    tcfg = _tcfg(JTrainConfig, pipelined, dtype, arch)
    with _f32():
        return _np(jax.jit(lambda s, g: _jax_step(tcfg, s, g, jloss))(
            jax.tree.map(jnp.asarray, _step_state(arch, dtype)),
            jax.tree.map(jnp.asarray, jgrads)))


@pytest.mark.parametrize("arch,impl,strategy,mesh,pipelined,dtype", STEPS)
def test_sharded_train_step_matches_the_reference(run, arch, impl, strategy,
                                                  mesh, pipelined, dtype):
    (job, recs), = [(j, r) for j, r in _records(run, "step")
                    if j["cfg"]["arch"] == arch and j["model"] == mesh[1]
                    and j["cfg"]["overrides"] == {"moe_impl": impl,
                                                  "sharding": strategy}]
    jstate, jmetrics = _reference_step(arch, impl, *mesh, pipelined, dtype)
    params = _by_name(arch, jstate["params"])
    for rec in recs:
        m = rec["metrics"]
        assert abs(m["loss"] - float(jmetrics["loss"])) <= LOSS_TOL
        assert m["gnorm"] == pytest.approx(float(jmetrics["gnorm"]),
                                           rel=1e-5)
        assert m["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-6)
        assert rec["repeat_equal"]
        assert _worst(rec["params"], params, rec["specs"], rec,
                      leaf_rtol=1e-6, floor=1e-7) <= 1.0
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0
        for w in ("m", "v"):
            want = _by_name(arch, jstate["opt"][w])
            top = max(float(np.abs(v).max()) for v in want.values())
            for k, v in want.items():
                blk = _block(v, rec["specs"][k], rec)
                bar = LEAF_RTOL * float(np.abs(v).max()) \
                    + GLOBAL_FLOOR * top + ulp * np.abs(blk)
                assert np.all(np.abs(rec["opt"][w][k] - blk) <= bar), k


def _ep_local_reference(job, data, model):
    jc = _jcfg("olmoe-1b-7b")       # capacity: experts / top_k
    if job["cfg"]["capacity"] == EP_DROP:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=EP_DROP))
    p = {"router": {"w": job["moe"]["router"]}, "up": job["moe"]["up"],
         "gate": job["moe"]["gate"], "down": job["moe"]["down"]}
    with _f32():
        out, aux = jax.jit(lambda p, x: _vmapped_ep(
            p, jc, x, jnp.float32, _EPHints(data, model).mesh))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(job["x"]))
    return np.asarray(out), {k: float(v) for k, v in aux.items()}


@pytest.mark.parametrize("capacity", [EP_DROP, "no_drop"])
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_moe_ep_matches_the_reference_ep_body(run, mesh, capacity):
    (i, (job, recs)), = [(i, (j, r)) for i, (j, r)
                         in enumerate(_records(run, "moe_ep"))
                         if j["model"] == mesh[1] and "strategy" not in j
                         and j["cfg"]["capacity"] == capacity]
    out, aux = run["ep_refs"][i]
    rows = B // mesh[0]
    drops = [rec["aux"]["moe_dropped"] for rec in recs]
    for rec in recs:
        d = rec["coords"]["data"]
        want = out[d * rows:(d + 1) * rows]
        assert np.abs(rec["out"] - want).max() <= 1e-5 * np.abs(want).max()
        for k in ("moe_aux", "moe_z"):
            assert abs(rec["aux"][k] - aux[k]) <= 1e-5 * abs(aux[k])
        if capacity == "no_drop":
            # no assignment drops: the rows are the gather route's
            assert rec["aux"]["moe_dropped"] == 0
            np.testing.assert_allclose(rec["out"], rec["gather_out"],
                                       rtol=0, atol=1e-5)
    if capacity == EP_DROP:
        assert min(drops) > 0


@pytest.mark.parametrize("mesh", EP_FSDP_MESHES)
def test_moe_ep_under_fsdp_matches_the_reference_ep_body(run, mesh):
    """The batch split over data and model: each rank's rows of the
    reference EP body's output (run per data shard, as its ``shard_map``
    reshards the rows), the shard's loss terms and its drops."""
    (i, (job, recs)), = [(i, (j, r)) for i, (j, r)
                         in enumerate(_records(run, "moe_ep"))
                         if j["model"] == mesh[1]
                         and j.get("strategy") == "fsdp"]
    out, aux = run["ep_refs"][i]
    for rec in recs:
        rows = _rows(rec, "fsdp")
        assert rows.stop - rows.start == B // WORLD
        want = out[rows]
        assert np.abs(rec["out"] - want).max() <= 1e-5 * np.abs(want).max()
        for k in ("moe_aux", "moe_z"):
            assert abs(rec["aux"][k] - aux[k]) <= 1e-5 * abs(aux[k])
        assert rec["aux"]["moe_dropped"] > 0


def _mesh_of(rec):
    """A mesh of the record's shape at its coordinates (no groups)."""
    shape, coords = rec["shape"], rec["coords"]
    rank = 0
    for a in shape:
        rank = rank * shape[a] + coords[a]
    return Mesh(shape, rank)


def _rows(rec, strategy):
    """The batch rows a rank of ``rec`` holds under ``strategy``."""
    mesh = _mesh_of(rec)
    axes = fit_batch_axes(mesh, B, strategy)
    n = B // mesh.count(axes)
    return slice(mesh.index(axes) * n, (mesh.index(axes) + 1) * n)


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, ov, prompt, steps, cache_len):
    """The JAX package's unsharded prefill of the first ``prompt`` tokens
    and ``prefill_to_decode_state`` (with no prompt ``init_decode_state``),
    then ``steps`` decode steps fed the next tokens, jitted: the logits
    (B, V) of the prefill and of each step, and the last state."""
    jc = _jcfg(arch, ov)
    toks = jnp.asarray(_dec_tokens(n=prompt + steps, ncb=jc.num_codebooks))

    def last(lg):   # (B, V) a codebook
        return ([np.asarray(t[:, -1]) for t in lg] if isinstance(lg, tuple)
                else np.asarray(lg[:, -1]))

    with _f32():
        params = jax.tree.map(jnp.asarray, _params(arch, ov))
        out = []
        if prompt:
            batch = {"tokens": toks[:, :prompt]}
            if jc.frontend is not None:
                batch["frontend"] = jnp.zeros(
                    (B, jc.frontend.num_positions, jc.d_model), jnp.bfloat16)
            lg, st = jax.jit(lambda p, b: jtf.prefill(p, jc, b))(params,
                                                                 batch)
            out.append(last(lg))
            st = j_prefill_to_decode(jc, st, cache_len)
        else:
            st = jtf.init_decode_state(jc, B, cache_len)
        step = jax.jit(lambda p, st, t: jtf.decode_step(p, jc, st, t))
        for i in range(steps):
            st, lg = step(params, st, toks[:, prompt + i])
            out.append(last(lg))
    return out, _np(st)


def _check_decode(rec, arch, strategy, ov, prompt, steps, cache_len):
    """A rank's logits rows and state blocks against the reference."""
    want, jstate = _reference_decode(arch, _shape_ov(ov), prompt, steps,
                                     cache_len)
    cfg = tsr.config(arch, dict(_shape_ov(ov)))
    rows = _rows(rec, strategy)
    assert len(rec["logits"]) == len(want)
    F = cfg.frontend.num_positions if cfg.frontend is not None else 0
    for step, (got, w) in enumerate(zip(rec["logits"], want)):
        for g, c in zip(*((x if isinstance(x, list) else [x])
                          for x in (got, w))):
            np.testing.assert_allclose(g[:, 0], c[rows], rtol=0,
                                       atol=DEC_TOL, err_msg=f"step {step}")
    assert rec["pos"] == F + prompt + steps
    # the reference's prefill leaves local layers' caches full length;
    # the port's decode state holds a ring of the window there
    whole = convert.decode_state_from_numpy(cfg, jstate, "cpu")
    mesh = _mesh_of(rec)
    axes = fit_batch_axes(mesh, B)
    for layer, (kind, st, got) in enumerate(zip(
            cfg.layer_kinds(), whole["layers"], rec["state"])):
        if kind == ATTN_LOCAL and st.k.shape[1] != cfg.window:
            st = type(st)(*(decode_cache(t[:, :rec["pos"]], rec["pos"],
                                         cache_len, cfg.window) for t in st))
        want_st = model_blocks(type(st)(*(comm.own_block(t, 0, mesh, axes)
                                          for t in st)), mesh)
        for f, g, w in zip(st._fields, got, want_st):
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=DEC_TOL,
                                       err_msg=f"layer {layer} {f}")


def _decode_id(i):
    arch, impl, strategy, _, ov = DECODE[i]
    tag = "-heads" if dict(ov).get("shard_attn_heads") else ""
    return f"{arch}-{impl}-{strategy}-mesh{i}{tag}" + (
        "-seq" if "num_heads" in dict(ov) else "")


@pytest.mark.parametrize("case", range(len(DECODE)), ids=_decode_id)
def test_sharded_decode_matches_the_reference(run, case):
    """A sharded prefill, ``sharding.decode_state`` and DEC_STEPS sharded
    decode steps: each rank's rows of every step's logits and its
    STATE_RULES blocks of the last state (the KV caches' sequence and the
    recurrent states' width over ``model``) against the JAX package's
    unsharded prefill / ``decode_step`` within tests/test_torch_lm.py's
    float32 bar."""
    arch, _, strategy, mesh, ov = DECODE[case]
    for rec in _case(run, "decode", case):
        assert rec["shape"] == {"data": mesh[0], "model": mesh[1]}
        _check_decode(rec, arch, strategy, ov, DEC_PROMPT, DEC_STEPS,
                      _dec_cache(arch))


def test_rolling_cache_wraps_past_the_window(run):
    """recurrentgemma's local attention from ``sharding.init_decode_state``:
    a ring of the window's 8 slots, 2 on each of 4 ranks, written by the
    slot's owner as ``pos % 8`` falls, ROLL_STEPS decode steps (pos wraps
    past the window) against the reference's own ring."""
    arch, _, strategy, _, ov = ROLLING
    cfg = tsr.config(arch)
    local = cfg.layer_kinds().index(ATTN_LOCAL)
    for rec in _case(run, "decode", "rolling"):
        assert rec["state"][local][0].shape[1] == cfg.window // 4
        _check_decode(rec, arch, strategy, ov, 0, ROLL_STEPS, ROLL_CACHE)


@pytest.mark.parametrize("mesh", SPLITS)
def test_tensor_parallel_splits_heads_kv_heads_ffn_and_vocab(run, mesh):
    """qwen3 (H 4, KV 2, D 16, d_ff 96, V 512) under "2d" with the heads
    split: what each rank computes.  On (2, 2) 2 query heads and 1 KV
    head a rank; on (1, 4) 1 query head and the one KV head it reads
    (KV does not divide: k and v whole, then selected); the FFN's hidden
    width and the vocabulary in quarters or halves; a decode step on (1,
    4), where no weight is split over ``data``, gathers no parameter."""
    cfg = tsr.config("qwen3-1.7b")
    m = mesh[1]
    rows = B // mesh[0]
    D, d = cfg.head_dim, cfg.d_model
    (_, recs), = [(j, r) for j, r in _records(run, "splits")
                  if j["model"] == m]
    for rec in recs:
        pre, dec = rec["prefill"], rec["decode"]
        kv = cfg.num_kv_heads // m if cfg.num_kv_heads % m == 0 else 1
        assert set(pre["attend"]) == {((rows, S, cfg.num_heads // m, D),
                                       (rows, S, kv, D))}
        blocks = dict(pre["block"])
        assert blocks["blocks.0.ffn.up.w"] == (d, cfg.d_ff // m)
        assert blocks["blocks.0.ffn.gate.w"] == (d, cfg.d_ff // m)
        assert blocks["blocks.0.ffn.down.w"] == (cfg.d_ff // m, d)
        assert blocks["blocks.0.attn.wq.w"] == (d, cfg.num_heads * D // m)
        assert blocks["blocks.0.attn.wo.w"] == (cfg.num_heads * D // m, d)
        assert blocks["embed"] == (cfg.vocab_size // m, d)
        assert set(pre["logits"]) == {(rows, 1, cfg.vocab_size // m)}
        assert dict(dec["block"])["blocks.0.attn.wk.w"] == (
            d, cfg.num_kv_heads * D // m)
        assert dec["attend"] == []      # decode reads its cache block
        if mesh[0] == 1:
            assert dec["gathered"] == 0
        else:
            assert dec["gathered"] > 0  # blocks gathered over data


def test_checkpoint_moves_between_meshes_and_one_device(run):
    """One device -> (2, 2) -> (4, 1) -> one device: each run restores the
    step the run before it saved and goes on as the uninterrupted run."""
    chain = list(run["chain"])
    for at, (_, recs) in zip((1, 2), _records(run, "train")):
        for rec in recs:
            assert rec["steps"] == 1
            assert abs(rec["losses"][0] - run["whole"][at]) <= CKPT_TOL
        chain[at] = recs[0]["losses"][0]
    assert len(chain) == CKPT_STEPS
    np.testing.assert_allclose(chain, run["whole"], rtol=0, atol=CKPT_TOL)


@pytest.mark.parametrize("arch,impl,strategy,mesh", PREFILL)
def test_sharded_prefill_rows_match_one_device(run, arch, impl, strategy,
                                               mesh):
    from repro_torch.convert import lm_params_from_numpy
    (job, recs), = [(j, r) for j, r in _records(run, "prefill")
                    if j["cfg"]["arch"] == arch and j["model"] == mesh[1]]
    cfg = tsr.config(arch, {"moe_impl": "gather"}, "no_drop")
    model = lm_params_from_numpy(cfg, _params(arch), "cpu")
    want, _ = steps.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(job["batch"]["tokens"])})
    want = want.numpy()
    for rec in recs:
        n = rec["rows"]
        i = rec["coords"]["data"] if strategy == "2d" else \
            rec["coords"]["data"] * mesh[1] + rec["coords"]["model"]
        np.testing.assert_allclose(rec["logits"], want[i * n:(i + 1) * n],
                                   rtol=0, atol=1e-5)
        assert sum(rec["launches"].values()) == 0


def test_stored_bytes_are_each_ranks_share_of_the_plan(run):
    for job, recs in _records(run, "storage"):
        for rec in recs:
            assert rec["held"] == rec["plan"], job["cfg"]


def test_a_step_refuses_parameters_placed_for_another_strategy():
    """Placement and the step's batch split both read ``cfg.sharding``: a
    model placed under "2d" and stepped with an "fsdp" config is refused
    before any collective."""
    from types import SimpleNamespace
    model = SimpleNamespace(shard_plan=SimpleNamespace(strategy="2d"))
    cfg = tsr.config("qwen3-1.7b", {"sharding": "fsdp"})
    with pytest.raises(ValueError, match="placed for '2d'"):
        steps._hints_for(model, cfg, Mesh({"data": 2, "model": 2}), {})


def test_decode_and_dry_run_under_a_mesh_name_the_next_slice():
    """The dry run under a mesh is the last slice (its name kept: decode
    under a mesh is done, above)."""
    cfg = tsr.config("qwen3-1.7b")
    mesh = Mesh({"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        steps.dryrun_lowerable(cfg, None, None, mesh)
