"""Training in the port against the JAX package, on the CPU.

Both packages get the same weights (the JAX ``init_params`` tree carried
across by ``lm_params_from_numpy``) and the same numpy batch, in float32
compute, for the ten smoke configs:

(a) ``loss_fn`` and its gradients at ``remat="none"``, ``"full"`` and
    ``"full"`` with ``save_attn_out``: the loss within 2e-5, each gradient
    leaf within 1e-4 of that leaf's max |g| plus 1e-6 of the max |g| over
    all leaves (the floor is for gradients that are zero in exact
    arithmetic, as a key bias's: both packages read rounding noise there);
    ``cross_entropy`` in both impls with and without a mask.
(b) One ``make_train_step`` from one state (random moments, step 3, a
    carried norm that clips), sync and delayed clipping, fp32 and bf16
    moments, for qwen3, olmoe, recurrentgemma and musicgen: the reference
    step is the JAX package's ``make_train_step`` body on its jitted
    gradients, itself held to the jitted JAX ``make_train_step`` once.
(c) AdamW, both clips and the schedule: the cases of test_substrates.py,
    each against the reference function on the same inputs.
(d) The data contract: deterministic and resumable, next-token labels,
    tokens in range, codebook and frontend shapes, the Markov structure;
    the Zipf logits and the permutation bit-equal to the reference's (the
    draws cannot be: ``jax.random`` against ``torch.Generator``).
(e) ``train()`` on qwen3 smoke: the loss falls as in test_system.py, and a
    run restored at step 6 of 10 repeats the uninterrupted losses bit for
    bit.
(f) ``DelayedValue`` / ``pipelined_scan`` against the reference.
(g) ``krylov_newton_step`` on the reference's quadratic (PIPECG and CG),
    the smoke model's HVP operator against the JAX ``hvp_operator`` on the
    same vector, and the pipelined and classical Newton directions within
    ``KN_DIRECTION_RTOL`` of each other (the bar chip_smoke.py holds the
    card to at full width).
(h) A config with ``attn_kernel=True`` is refused before step 0, and
    serving records no graph.

One JAX jit of the loss's value and gradient per arch, shared by (a) and
(b).
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.distributed import overlap as joverlap
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import clipping as jclip
from repro.optim import krylov_newton as jkn
from repro.optim import schedules as jsched
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import overlap as toverlap
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import build_state, train
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw, clipping, schedules
from repro_torch.optim import krylov_newton as tkn

ARCHS = tuple(jreg.list_archs())
STEP_ARCHS = ("qwen3-1.7b", "olmoe-1b-7b", "recurrentgemma-2b",
              "musicgen-medium")
LOSS_TOL = 2e-5
LEAF_RTOL = 1e-4      # of the leaf's max |g|
GLOBAL_FLOOR = 1e-6   # of the max |g| over all leaves
KN_DIRECTION_RTOL = 1e-3
B, S = 2, 16
#: the LM is float32 in both packages; JAX traces and compiles it about
#: 2.5x faster with x64 (which tests/conftest.py turns on) off
F32 = jax.enable_x64(False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=3):
    """numpy tokens, labels, a mask (B, S) and, with a frontend, floats."""
    g = np.random.default_rng(seed)
    shape = (B, S) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    b = {"tokens": g.integers(0, cfg.vocab_size, shape).astype(np.int32),
         "labels": g.integers(0, cfg.vocab_size, shape).astype(np.int32),
         "mask": (g.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.frontend is not None:
        b["frontend"] = g.standard_normal(
            (B, cfg.frontend.num_positions, cfg.d_model)).astype(np.float32)
    return b


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _configs(arch, **kw):
    jc = dataclasses.replace(jreg.smoke_config(arch), dtype="float32", **kw)
    tc = dataclasses.replace(treg.smoke_config(arch), dtype="float32", **kw)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX params and batch (numpy), and the jitted loss, metrics and
    gradients of ``loss_fn`` on them."""
    jc, _ = _configs(arch)
    with F32:
        jp = jtf.init_params(jc, jax.random.PRNGKey(0))
        b = _batch(jc)
        vg = jax.jit(jax.value_and_grad(
            lambda p, bb: jtf.loss_fn(p, jc, bb, remat="none"),
            has_aux=True))
        (loss, metrics), grads = vg(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    return jp, b, float(loss), _np(metrics), grads


def _by_name(tc, tree):
    """A reference params-shaped numpy tree as {port name: tensor}."""
    return {k: p.detach() for k, p in
            lm_params_from_numpy(tc, _np(tree), device="cpu")
            .named_parameters()}


def _worst(got: dict, want: dict, leaf_rtol=LEAF_RTOL,
           floor=GLOBAL_FLOOR) -> float:
    """max over leaves of max |got - want| over its bar (<= 1 passes)."""
    assert got.keys() == want.keys()
    top = max(float(w.float().abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        bar = leaf_rtol * float(w.float().abs().max()) + floor * top
        gap = float((got[k].float() - w.float()).abs().max())
        worst = max(worst, gap / bar if bar else (0.0 if gap == 0 else
                                                  float("inf")))
    return worst


# --- (a) loss and gradients --------------------------------------------------

@pytest.mark.parametrize("remat,save_attn_out", [
    ("none", False), ("full", False), ("full", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, remat, save_attn_out):
    jp, b, jloss, jmetrics, jgrads = _reference(arch)
    _, tc = _configs(arch, save_attn_out=save_attn_out)
    model = lm_params_from_numpy(tc, _np(jp), device="cpu")
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = ttf.loss_fn(model, tc, _tbatch(b), remat=remat)
    grads = dict(zip(named, torch.autograd.grad(
        loss, list(named.values()), materialize_grads=True)))
    assert abs(float(loss) - jloss) <= LOSS_TOL
    assert abs(float(metrics["ce"]) - float(jmetrics["ce"])) <= LOSS_TOL
    for key in ("moe_aux", "moe_z"):
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= LOSS_TOL
    assert _worst(grads, _by_name(tc, jgrads)) <= 1.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_cross_entropy_matches_the_reference(impl, masked):
    g = np.random.default_rng(5)
    logits = (3 * g.standard_normal((3, 7, 50))).astype(np.float32)
    labels = g.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (g.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), impl)
    got = tlayers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), impl)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# --- (b) one train step ------------------------------------------------------

def _state(jp, jgrads, dtype, seed=11):
    """Moments drawn at the gradients' RMS (v bounded away from eps, so
    AdamW's update is well conditioned everywhere), step 3, a carried
    norm of 2 (it clips at grad_clip 1)."""
    leaves = jax.tree.leaves(jgrads)
    rms = float(np.sqrt(sum(float(jnp.sum(jnp.square(leaf)))
                            for leaf in leaves) /
                        sum(leaf.size for leaf in leaves)))
    g = np.random.default_rng(seed)
    m = jax.tree.map(lambda p: (rms * g.standard_normal(p.shape))
                     .astype(np.float32), _np(jp))
    v = jax.tree.map(lambda p: (rms ** 2 * (0.5 + g.random(p.shape)))
                     .astype(np.float32), _np(jp))
    m, v = (jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(dtype)),
                         t) for t in (m, v))
    return {"params": _np(jp), "opt": {"m": m, "v": v},
            "step": np.int32(3), "prev_gnorm": np.float32(2.0)}


def _jax_step(tcfg, state, grads, loss):
    """The JAX package's ``make_train_step`` body after its value_and_grad
    (repro/launch/steps.py), traced inside a caller's jit."""
    if tcfg.grad_clip > 0:
        if tcfg.pipelined_clipping:
            grads, gnorm = jclip.clip_by_delayed_norm(
                grads, state["prev_gnorm"], tcfg.grad_clip)
        else:
            grads, gnorm = jclip.clip_by_global_norm(grads, tcfg.grad_clip)
    else:
        gnorm = jclip.global_norm(grads)
    step = state["step"] + 1
    lr = jsched.linear_warmup_cosine(
        step, base_lr=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
        total_steps=max(tcfg.steps, 1))
    new_params, new_opt = jadamw.update(
        grads, state["opt"], state["params"], lr=lr,
        weight_decay=tcfg.weight_decay, step=step)
    return {"params": new_params, "opt": new_opt, "step": step,
            "prev_gnorm": gnorm}, {"loss": loss, "gnorm": gnorm, "lr": lr}


STEP_CASES = [(pipelined, dtype) for pipelined in (False, True)
              for dtype in ("float32", "bfloat16")]


@functools.lru_cache(maxsize=None)
def _reference_steps(arch):
    """{(pipelined, dtype): (state, metrics)} of the reference step from
    :func:`_state`, all four in one jit."""
    jp, _, jloss, _, jgrads = _reference(arch)
    states = {dt: _state(jp, jgrads, getattr(jnp, dt))
              for dt in ("float32", "bfloat16")}
    name = jreg.smoke_config(arch).name

    def steps(states, grads):
        return [_jax_step(_tcfg(JTrainConfig, pl, dt, name), states[dt],
                          grads, jloss) for pl, dt in STEP_CASES]

    with F32:
        out = jax.jit(steps)(jax.tree.map(jnp.asarray, states), jgrads)
    return states, dict(zip(STEP_CASES, out))


def _tcfg(cls, pipelined, dtype, name):
    return cls(model=name, steps=10, warmup_steps=2, learning_rate=1e-3,
               grad_clip=1.0, pipelined_clipping=pipelined,
               optimizer_state_dtype=dtype)


def _hold_step(tc, tstate, tmetrics, jstate, jmetrics, dtype):
    assert abs(float(tmetrics["loss"]) - float(jmetrics["loss"])) <= LOSS_TOL
    assert float(tmetrics["gnorm"]) == pytest.approx(
        float(jmetrics["gnorm"]), rel=1e-5)
    assert float(tmetrics["lr"]) == pytest.approx(float(jmetrics["lr"]),
                                                  rel=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 4
    assert float(tstate["prev_gnorm"]) == float(tmetrics["gnorm"])
    old = dict(tstate["params"].named_parameters())
    assert _worst({k: p.detach() for k, p in old.items()},
                  _by_name(tc, jstate["params"]), leaf_rtol=1e-6,
                  floor=1e-7) <= 1.0
    # moments as gradients are held; bf16 ones may round a value within
    # that bar to the next bf16 number as well (2^-7 of the value)
    for key in ("m", "v"):
        got = tstate["opt"][key]
        want = _by_name(tc, jstate["opt"][key])
        assert all(got[k].dtype == getattr(torch, dtype) for k in got)
        top = max(float(w.float().abs().max()) for w in want.values())
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0
        for k, w in want.items():
            w = w.float()
            bar = LEAF_RTOL * float(w.abs().max()) + GLOBAL_FLOOR * top \
                + ulp * w.abs()
            assert bool(torch.all((got[k].float() - w).abs() <= bar)), k


@pytest.mark.parametrize("pipelined,dtype", STEP_CASES)
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_the_reference(arch, pipelined, dtype):
    _, b, _, _, _ = _reference(arch)
    _, tc = _configs(arch)
    states, steps = _reference_steps(arch)
    jstate, jmetrics = steps[(pipelined, dtype)]
    tstate = train_state_from_numpy(tc, states[dtype], device="cpu")
    tstate, tmetrics = make_train_step(
        tc, _tcfg(TrainConfig, pipelined, dtype, tc.name))(tstate,
                                                          _tbatch(b))
    assert set(tmetrics) == {"loss", "ce", "moe_aux", "moe_z",
                             "moe_dropped", "gnorm", "lr"}
    _hold_step(tc, tstate, tmetrics, jstate, jmetrics, dtype)


def test_reference_step_is_the_jax_train_step():
    """The composed reference of (b) is the JAX package's own jitted
    ``make_train_step`` (qwen3 smoke, sync clipping, fp32 moments)."""
    arch = "qwen3-1.7b"
    _, b, _, _, _ = _reference(arch)
    jc, _ = _configs(arch)
    states, steps = _reference_steps(arch)
    state = states["float32"]
    tcfg = _tcfg(JTrainConfig, False, "float32", jc.name)
    want, wm = steps[(False, "float32")]
    with F32:
        got, gm = jax.jit(j_make_train_step(jc, tcfg))(
            jax.tree.map(jnp.asarray, state),
            {k: jnp.asarray(v) for k, v in b.items()})
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert float(gm["gnorm"]) == pytest.approx(float(wm["gnorm"]), rel=1e-6)


# --- (c) AdamW, clipping, schedules ------------------------------------------

def _adamw_quadratic():
    out = []
    for mod, arr in ((jadamw, jnp.asarray), (adamw, torch.tensor)):
        params = {"w": arr([5.0, -3.0])}
        opt = mod.init(params)
        target = arr([1.0, 2.0])
        for step in range(1, 400):
            g = {"w": 2 * (params["w"] - target)}
            params, opt = mod.update(g, opt, params, lr=0.05,
                                     weight_decay=0.0, step=step)
        out.append(np.asarray(params["w"]))
    np.testing.assert_allclose(out[1], [1.0, 2.0], atol=1e-2)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5)


def _adamw_single_step():
    m, v = 0.1 * 0.5, 0.05 * 0.25
    want = 1.0 - 0.1 * (m / 0.1) / (np.sqrt(v / 0.05) + 1e-8)
    res = []
    for mod, arr in ((jadamw, jnp.asarray), (adamw, torch.tensor)):
        p, g = {"w": arr([1.0])}, {"w": arr([0.5])}
        new_p, new_opt = mod.update(g, mod.init(p), p, lr=0.1, b1=0.9,
                                    b2=0.95, eps=1e-8, weight_decay=0.0,
                                    step=1)
        res.append((float(new_p["w"][0]), float(new_opt["m"]["w"][0]),
                    float(new_opt["v"]["w"][0])))
    assert res[1][0] == pytest.approx(want, rel=1e-6)
    assert res[1][1] == pytest.approx(m, rel=1e-6)
    assert res[1] == res[0]
    # a list of parameters takes the same arithmetic
    p, opt = adamw.update([torch.tensor([0.5])], adamw.init(
        [torch.tensor([1.0])]), [torch.tensor([1.0])], lr=0.1,
        weight_decay=0.0, step=1)
    assert (float(p[0][0]), float(opt["m"][0][0]),
            float(opt["v"][0][0])) == res[1]


def _adamw_bf16_states():
    g = np.random.default_rng(2)
    p0 = g.standard_normal(64).astype(np.float32)
    g0 = (0.1 * g.standard_normal(64)).astype(np.float32)
    jp, jo = jadamw.update({"w": jnp.asarray(g0)},
                           jadamw.init({"w": jnp.asarray(p0)}, "bfloat16"),
                           {"w": jnp.asarray(p0)}, lr=0.01, step=1)
    tp, to = adamw.update({"w": torch.from_numpy(g0)},
                          adamw.init({"w": torch.from_numpy(p0.copy())},
                                     "bfloat16"),
                          {"w": torch.from_numpy(p0.copy())}, lr=0.01,
                          step=1)
    assert to["m"]["w"].dtype == to["v"]["w"].dtype == torch.bfloat16
    assert bool(torch.all(torch.isfinite(tp["w"])))
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    for key in ("m", "v"):
        np.testing.assert_array_equal(
            to[key]["w"].float().numpy(),
            np.asarray(jo[key]["w"].astype(jnp.float32)))


def _sync_clip():
    c, n = clipping.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    jc, jn = jclip.clip_by_global_norm({"a": jnp.asarray([3.0, 4.0])}, 1.0)
    assert float(n) == pytest.approx(5.0) == float(jn)
    assert float(clipping.global_norm(c)) == pytest.approx(1.0)
    np.testing.assert_array_equal(c["a"].numpy(), np.asarray(jc["a"]))
    cl, nl = clipping.clip_by_global_norm([torch.tensor([3.0, 4.0])], 1.0)
    assert torch.equal(cl[0], c["a"]) and float(nl) == float(n)


def _delayed_clip():
    g = {"a": torch.tensor([3.0, 4.0])}
    jg = {"a": jnp.asarray([3.0, 4.0])}
    for prev, want in ((10.0, 0.5), (0.0, 5.0)):
        c, n = clipping.clip_by_delayed_norm(g, torch.tensor(prev), 1.0)
        jc, jn = jclip.clip_by_delayed_norm(jg, jnp.asarray(prev), 1.0)
        assert float(n) == pytest.approx(5.0) == float(jn)
        assert float(clipping.global_norm(c)) == pytest.approx(want)
        np.testing.assert_array_equal(c["a"].numpy(), np.asarray(jc["a"]))


def _delayed_equals_sync_below_threshold():
    g = {"a": torch.tensor([0.3, 0.4])}
    c1, n1 = clipping.clip_by_global_norm(g, 1.0)
    c2, n2 = clipping.clip_by_delayed_norm(g, torch.tensor(0.9), 1.0)
    assert torch.equal(c1["a"], c2["a"]) and float(n1) == float(n2)


def _schedule():
    kw = dict(base_lr=1.0, warmup_steps=10, total_steps=100)
    got = [float(schedules.linear_warmup_cosine(s, **kw))
           for s in range(0, 121)]
    want = [float(jsched.linear_warmup_cosine(s, **kw))
            for s in range(0, 121)]
    assert got[0] == 0.0 and got[10] == pytest.approx(1.0)
    assert got[100] == pytest.approx(0.1, abs=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert float(schedules.constant(7, base_lr=0.3)) == \
        float(jsched.constant(7, base_lr=0.3))


SUBSTRATE_CASES = {
    "adamw_minimizes_quadratic": _adamw_quadratic,
    "adamw_reference_single_step": _adamw_single_step,
    "adamw_bf16_states": _adamw_bf16_states,
    "sync_clip_scales_to_max_norm": _sync_clip,
    "delayed_clip_uses_previous_norm": _delayed_clip,
    "delayed_equals_sync_below_threshold":
        _delayed_equals_sync_below_threshold,
    "schedule_warmup_and_decay": _schedule,
}


@pytest.mark.parametrize("case", sorted(SUBSTRATE_CASES))
def test_optimizer_substrate_matches_the_reference(case):
    SUBSTRATE_CASES[case]()


# --- (d) data ----------------------------------------------------------------

def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=7)
    d1, d2 = SyntheticTokens(cfg, device="cpu"), SyntheticTokens(
        cfg, device="cpu")
    b5a, b5b = d1.batch(5), d2.batch(5)
    assert torch.equal(b5a["tokens"], b5b["tokens"])
    assert torch.equal(next(d2.iter_from(5))["tokens"], b5a["tokens"])
    assert not torch.equal(d1.batch(6)["tokens"], b5a["tokens"])
    assert b5a["tokens"].shape == (4, 16)
    assert b5a["tokens"].dtype == b5a["labels"].dtype == torch.int32
    assert 0 <= int(b5a["tokens"].min()) and int(b5a["tokens"].max()) < 128
    assert torch.equal(b5a["labels"][:, :-1], b5a["tokens"][:, 1:])


def test_data_learnable_structure():
    """The Markov component makes labels predictable beyond unigram, as in
    the reference: fewer than half of the pairs occur, and a label follows
    perm[token] about a quarter of the time in both streams."""
    cfg = DataConfig(vocab_size=64, seq_len=512, global_batch=2, seed=1)
    t = SyntheticTokens(cfg, device="cpu").batch(0)["tokens"].reshape(-1)
    assert len(set(zip(t[:-1].tolist(), t[1:].tolist()))) < 64 * 64 * 0.5
    big = dict(vocab_size=4096, seq_len=1024, global_batch=4, seed=1)
    tt = SyntheticTokens(DataConfig(**big), device="cpu")
    jt = JSyntheticTokens(JDataConfig(**big))

    def follows(tokens, labels, perm):
        return float(np.mean(perm[tokens] == labels))

    perm = tt._perm.numpy()
    tb, jb = tt.batch(0), jt.batch(0)
    ft = follows(tb["tokens"].numpy(), tb["labels"].numpy(), perm)
    fj = follows(np.asarray(jb["tokens"]), np.asarray(jb["labels"]), perm)
    assert 0.2 < ft < 0.35 and abs(ft - fj) < 0.03, (ft, fj)


def test_zipf_logits_and_perm_bit_equal_to_the_reference():
    cfg = dict(vocab_size=1000, seq_len=8, global_batch=2, seed=13)
    tt = SyntheticTokens(DataConfig(**cfg), device="cpu")
    jt = JSyntheticTokens(JDataConfig(**cfg))
    np.testing.assert_array_equal(tt._perm.numpy(), np.asarray(jt._perm))
    np.testing.assert_array_equal(tt._logits.numpy(), np.asarray(jt._logits))
    assert tt._perm.dtype == torch.int32 and tt._logits.dtype == torch.float32


def test_data_codebooks_and_frontend():
    cfg = DataConfig(vocab_size=100, seq_len=12, global_batch=3, seed=2,
                     num_codebooks=4, frontend_positions=5, d_model=64)
    b = SyntheticTokens(cfg, device="cpu").batch(1)
    jb = JSyntheticTokens(JDataConfig(**dataclasses.asdict(cfg))).batch(1)
    for key in ("tokens", "labels", "frontend"):
        assert tuple(b[key].shape) == tuple(jb[key].shape)
    assert b["tokens"].shape == (3, 12, 4)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["frontend"].dtype == torch.bfloat16
    assert 0.015 < float(b["frontend"].float().std()) < 0.025


# --- (e) the training loop ---------------------------------------------------

def test_training_loss_decreases():
    """As test_system.py: 60 steps of the reduced qwen3 family."""
    cfg = treg.smoke_config("qwen3-1.7b")
    tcfg = TrainConfig(model=cfg.name, steps=60, learning_rate=1e-3)
    out = train(cfg, tcfg, seq_len=64, batch=4, log_every=0, device="cpu")
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.1, (first, last)
    assert len(out["step_seconds"]) == 60


def test_restart_repeats_the_uninterrupted_run_bit_for_bit(tmp_path):
    cfg = treg.smoke_config("qwen3-1.7b")
    full = tmp_path / "full"
    out = train(cfg, TrainConfig(model=cfg.name, steps=10,
                                 checkpoint_dir=str(full),
                                 checkpoint_every=6, pipelined_clipping=True),
                seq_len=32, batch=2, log_every=0, device="cpu")
    # a run that stopped at step 6: only that checkpoint is there
    cut = tmp_path / "cut"
    cut.mkdir()
    shutil.copytree(full / "step_0000000006", cut / "step_0000000006")
    (cut / "LATEST").write_text("6")
    msgs = []
    out2 = train(cfg, TrainConfig(model=cfg.name, steps=10,
                                  checkpoint_dir=str(cut),
                                  pipelined_clipping=True),
                 seq_len=32, batch=2, log_every=0, device="cpu",
                 progress=msgs.append)
    assert msgs == ["[train] restored checkpoint at step 6"]
    assert out2["steps"] == 4
    assert out2["losses"] == out["losses"][6:]
    for (k, a), (_, b) in zip(out["state"]["params"].named_parameters(),
                              out2["state"]["params"].named_parameters()):
        assert torch.equal(a, b), k
    assert torch.equal(out["state"]["prev_gnorm"], out2["state"]["prev_gnorm"])


# --- (f) the delayed reduction -----------------------------------------------

def test_delayed_value_semantics():
    d = toverlap.delayed_init(torch.tensor(0.0))
    assert not bool(d.valid)
    v, valid, d2 = toverlap.delayed_update(d, torch.tensor(7.0))
    assert float(v) == 0.0 and not bool(valid)
    v2, valid2, _ = toverlap.delayed_update(d2, torch.tensor(9.0))
    assert float(v2) == 7.0 and bool(valid2)


def test_pipelined_scan_matches_the_reference():
    xs = np.random.default_rng(4).standard_normal((6, 3)).astype(np.float32)

    def body(lib):
        def f(carry, x, red):
            value, valid = red
            scale = lib.where(valid, value, 1.0)
            carry = carry + x * scale
            return carry, carry.sum(), x * x
        return f

    jc, jys, jd = joverlap.pipelined_scan(
        body(jnp), lambda r: jnp.sqrt(jnp.sum(r)), jnp.zeros(3, jnp.float32),
        jnp.asarray(xs), jnp.asarray(0.5, jnp.float32))
    tc, tys, td = toverlap.pipelined_scan(
        body(torch), lambda r: torch.sqrt(torch.sum(r)), torch.zeros(3),
        torch.from_numpy(xs), torch.tensor(0.5))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-6,
                               atol=1e-6)
    assert float(td.value) == pytest.approx(float(jd.value), rel=1e-6)
    assert bool(td.valid) and bool(jd.valid)


# --- (g) Krylov-Newton -------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True])
def test_krylov_newton_quadratic_matches_the_reference(pipelined):
    A = np.asarray([[3.0, 0.5], [0.5, 1.0]], np.float32)
    b = np.asarray([1.0, -2.0], np.float32)
    jA, jb, tA, tb = jnp.asarray(A), jnp.asarray(b), torch.from_numpy(A), \
        torch.from_numpy(b)
    p1, m = tkn.krylov_newton_step(
        lambda p: 0.5 * p["w"] @ tA @ p["w"] - tb @ p["w"],
        {"w": torch.zeros(2)}, cg_iters=10, damping=1e-9,
        pipelined=pipelined)
    jp1, jm = jkn.krylov_newton_step(
        lambda p: 0.5 * p["w"] @ jA @ p["w"] - jb @ p["w"],
        {"w": jnp.zeros(2, jnp.float32)}, cg_iters=10, damping=1e-9,
        pipelined=pipelined)
    np.testing.assert_allclose(p1["w"].numpy(), np.linalg.solve(A, b),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p1["w"].numpy(), np.asarray(jp1["w"]),
                               rtol=1e-6, atol=1e-7)
    # (the iteration counts of a 2 x 2 system, converged after two steps,
    # depend on where each package's rounding first reaches rr = 0)
    assert float(m["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-6)
    assert float(m["cg_res"]) <= 1e-5 and float(jm["cg_res"]) <= 1e-5


def _smoke_loss(arch="qwen3-1.7b"):
    jp, b, _, _, _ = _reference(arch)
    jc, tc = _configs(arch)
    model = lm_params_from_numpy(tc, _np(jp), device="cpu")
    tb = _tbatch(b)
    f = tkn.module_loss(model, lambda m: ttf.loss_fn(m, tc, tb,
                                                     remat="none")[0])
    return jp, jc, tc, b, model, f


def test_hvp_operator_matches_the_reference():
    jp, jc, tc, b, model, f = _smoke_loss()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    g = np.random.default_rng(9)
    v_tree = jax.tree.map(lambda p: g.standard_normal(p.shape)
                          .astype(np.float32), _np(jp))
    with F32:
        jhvp = jkn.hvp_operator(lambda p: jtf.loss_fn(p, jc, jb,
                                                      remat="none")[0],
                                jp, 1e-3)
        jhv = jax.jit(jhvp)(jkn._tree_to_vec(jax.tree.map(jnp.asarray,
                                                          v_tree)))
    want = _by_name(tc, jkn._vec_to_tree(jhv, jp))
    params = {k: p.detach() for k, p in model.named_parameters()}
    tv = tkn._tree_to_vec(_by_name(tc, v_tree))
    got = tkn._vec_to_tree(tkn.hvp_operator(f, params, 1e-3)(tv), params)
    assert _worst(got, want) <= 1.0


def test_krylov_newton_directions_agree_on_the_smoke_model():
    """PIPECG and classical CG give one Newton direction within
    KN_DIRECTION_RTOL (10 iterations, float32: their rounding orders
    differ)."""
    _, _, _, _, model, f = _smoke_loss()
    params = dict(model.named_parameters())
    dirs, loss = [], []
    for pipelined in (True, False):
        new, m = tkn.krylov_newton_step(f, params, cg_iters=10,
                                        damping=1e-2, pipelined=pipelined)
        dirs.append(torch.cat([(new[k] - params[k]).reshape(-1)
                               for k in params]))
        loss.append(float(m["loss"]))
        assert bool(torch.isfinite(m["cg_res"])) and int(m["cg_iters"]) == 10
    assert loss[0] == loss[1]
    rel = float((dirs[0] - dirs[1]).norm() / dirs[1].norm())
    assert rel <= KN_DIRECTION_RTOL, rel


# --- (h) the guard, and serving without a graph ------------------------------

def test_training_refuses_the_flash_kernel():
    cfg = dataclasses.replace(treg.smoke_config("qwen3-1.7b"),
                              attn_kernel=True)
    with pytest.raises(ValueError, match="no backward"):
        train(cfg, TrainConfig(model=cfg.name, steps=2), seq_len=8, batch=1,
              log_every=0, device="cpu")


def test_serving_records_no_graph_and_training_switches_it_on():
    cfg = treg.smoke_config("qwen3-1.7b")
    out = serve(cfg, batch=1, prompt_len=4, decode_steps=2,
                progress=lambda *_: None, device="cpu")
    assert not out["logits"].requires_grad
    model = ttf.init_params(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    state = build_state(cfg, TrainConfig(model=cfg.name), device="cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    assert state["opt"]["m"].keys() == dict(
        state["params"].named_parameters()).keys()


def _example(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_example_runs_on_the_cpu(tmp_path):
    out = _example("train_lm_torch.py").main(
        ["--steps", "3", "--seq-len", "16", "--batch", "2", "--device",
         "cpu", "--checkpoint-dir", str(tmp_path)])
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    assert (tmp_path / "LATEST").read_text() == "3"


def test_serve_example_runs_on_the_cpu():
    outs = _example("serve_lm_torch.py").main(
        ["--batch", "1", "--prompt-len", "4", "--decode-steps", "3",
         "--device", "cpu"])
    assert set(outs) == {"qwen3-1.7b", "recurrentgemma-2b",
                         "musicgen-medium"}
    assert outs["musicgen-medium"]["tokens"].shape == (1, 3, 4)
