"""The port's MoE, RG-LRU and RWKV-6 blocks, codebooks and frontends
against the JAX package's functions, on the CPU.

Each module gets the JAX initialiser's weights carried across (numpy
copies) and the same numpy inputs from a seed, at smoke widths, in
float32: outputs, aux terms and carried states agree to 2e-5 absolute
(the two differ in summation order: the port's batched products, its
doubling scan in place of ``associative_scan``, its chunk loop in place of
``lax.scan``).  The chunked wkv form is also held to the plain version of
the ``wkv_recurrent`` kernel from a zero state, and its last state to a
step-by-step recurrence.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models import recurrent as jrec
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.wkv import wkv_recurrent, wkv_recurrent_plain
from repro_torch.models import moe as tmoe
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import Linear

TOL = 2e-5
F32 = torch.float32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lin(p):
    return Linear(_t(p["w"]), _t(p["b"]) if "b" in p else None)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jreg.smoke_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(treg.smoke_config(arch), dtype="float32",
                                **kw))


def _jit_block(fn, cfg, mode):
    """The reference block ``fn`` under ``jax.jit`` (eager JAX compiles
    each op on first use: seconds a call at these widths)."""
    return jax.jit(lambda p, x, state: fn(p, cfg, x, jnp.float32, mode=mode,
                                          state=state))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_pair(arch, capacity_factor=None, seed=0):
    jc, tc = _cfgs(arch)
    if capacity_factor is not None:
        moe = dataclasses.replace(jc.moe, capacity_factor=capacity_factor)
        jc = dataclasses.replace(jc, moe=moe)
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=capacity_factor))
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jc)
    n = _np(jp)
    tp = tmoe.MoE(_lin(n["router"]), _t(n["up"]), _t(n["down"]),
                  _t(n["gate"]) if "gate" in n else None)
    return jc, tc, jp, tp


@pytest.mark.parametrize("arch,B,S,cf", [
    ("olmoe-1b-7b", 2, 16, None),     # SwiGLU experts, nothing dropped
    ("arctic-480b", 2, 16, None),
    ("olmoe-1b-7b", 4, 32, 0.5),      # a capacity that drops tokens
    ("musicgen-medium", 2, 8, None),  # not a MoE config: below
    ("olmoe-1b-7b", 4, 1, None),      # the decode case, T = B
])
def test_moe_ffn_matches_reference(rng, arch, B, S, cf):
    if arch == "musicgen-medium":  # tanh-GELU experts: a MoE on a GeLU cfg
        jc, tc = _cfgs(arch)
        moe = jreg.smoke_config("olmoe-1b-7b").moe
        jc = dataclasses.replace(jc, moe=moe)
        tc = dataclasses.replace(tc, moe=treg.smoke_config("olmoe-1b-7b")
                                 .moe)
        jp = jmoe.init_moe(jax.random.PRNGKey(1), jc)
        n = _np(jp)
        assert "gate" not in n
        tp = tmoe.MoE(_lin(n["router"]), _t(n["up"]), _t(n["down"]))
    else:
        jc, tc, jp, tp = _moe_pair(arch, cf)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    want, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, jc, x, jnp.float32))(
        jp, jnp.asarray(x))
    got, taux = tmoe.moe_ffn(tp, tc, _t(x), F32)
    _close(got.numpy(), want)
    for k in ("moe_aux", "moe_z"):
        _close(float(taux[k]), float(jaux[k]))
    # the drop count against the reference's routing, counted in numpy
    T, E, K = B * S, jc.moe.num_experts, jc.moe.top_k
    C = jmoe.capacity(jc.moe, T)
    logits = x.reshape(T, -1) @ np.asarray(jp["router"]["w"])
    idx = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)),
                                   K)[1])
    per_e = np.bincount(idx.reshape(-1), minlength=E)
    want_drop = int(np.maximum(per_e - C, 0).sum())
    assert int(taux["moe_dropped"]) == want_drop
    if cf == 0.5:
        assert want_drop > 0
    if S == 1:
        assert C == 8 and want_drop == 0


def test_moe_ffn_is_deterministic_and_drops_the_latest_assignments(rng):
    """Two calls give the same bits, and the output is, token by token,
    the sum of its kept assignments' weighted expert rows, where an
    expert keeps its first C assignments in (token, k) order (the stable
    sort) and drops the rest: a direct per-token evaluation in float64."""
    jc, tc, jp, tp = _moe_pair("olmoe-1b-7b", 0.25, seed=3)
    B, S, d = 4, 32, jc.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    a, aux = tmoe.moe_ffn(tp, tc, _t(x), F32)
    b, _ = tmoe.moe_ffn(tp, tc, _t(x), F32)
    assert torch.equal(a, b)
    T, E, K = B * S, jc.moe.num_experts, jc.moe.top_k
    C = tmoe.capacity(tc.moe, T)
    xf = x.reshape(T, d).astype(np.float64)
    probs = torch.softmax(_t(xf) @ tp.router.w.double(), -1)
    w, idx = torch.topk(probs, K, dim=-1)
    w = (w / w.sum(-1, keepdim=True)).numpy()
    idx = idx.numpy()
    up, gate, down = (t.double().numpy() for t in (tp.up, tp.gate, tp.down))
    seen = np.zeros(E, int)
    want = np.zeros((T, d))
    for t in range(T):
        for k in range(K):
            e = idx[t, k]
            seen[e] += 1
            if seen[e] > C:
                continue
            g = xf[t] @ gate[e]
            h = g / (1.0 + np.exp(-g)) * (xf[t] @ up[e])
            want[t] += w[t, k] * (h @ down[e])
    assert int(aux["moe_dropped"]) == int(np.maximum(seen - C, 0).sum()) > 0
    _close(a.reshape(T, d).numpy(), want)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_pair(seed=0):
    jc, tc = _cfgs("recurrentgemma-2b", use_bias=True)
    jp = jrec.init_rglru(jax.random.PRNGKey(seed), jc)
    n = _np(jp)
    tp = trec.RGLRU(_lin(n["in_x"]), _lin(n["in_gate"]), _t(n["conv_w"]),
                    _lin(n["gate_a"]), _lin(n["gate_i"]), _t(n["lambda"]),
                    _lin(n["out"]))
    return jc, tc, jp, tp


@pytest.mark.parametrize("S", [1, 13, 64])
def test_rglru_prefill_matches_reference(rng, S):
    jc, tc, jp, tp = _rglru_pair()
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    want, jst = _jit_block(jrec.rglru_block, jc, "prefill")(
        jp, jnp.asarray(x), None)
    got, tst = trec.rglru_block(tp, tc, _t(x), F32, mode="prefill")
    _close(got.numpy(), want)
    _close(tst.h.numpy(), jst.h)
    _close(tst.conv.numpy(), jst.conv)
    assert tst.h.dtype == F32 and tst.conv.shape == (2, 3, 64)


def test_rglru_decode_and_segments_match_reference(rng):
    """Decode steps from a carried state against the reference's, and two
    carried segments against one whole pass."""
    jc, tc, jp, tp = _rglru_pair(seed=4)
    x = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    _, jst = _jit_block(jrec.rglru_block, jc, "prefill")(jp, jx[:, :16],
                                                         None)
    _, tst = trec.rglru_block(tp, tc, tx[:, :16], F32, mode="prefill")
    for i in range(16, 20):
        want, jst = _jit_block(jrec.rglru_block, jc, "decode")(
            jp, jx[:, i:i + 1], jst)
        got, tst = trec.rglru_block(tp, tc, tx[:, i:i + 1], F32,
                                    mode="decode", state=tst)
        _close(got.numpy(), want)
        _close(tst.h.numpy(), jst.h)
    whole, wst = trec.rglru_block(tp, tc, tx, F32, mode="prefill")
    a, ast = trec.rglru_block(tp, tc, tx[:, :10], F32, mode="prefill")
    b, bst = trec.rglru_block(tp, tc, tx[:, 10:], F32, mode="prefill",
                              state=ast)
    _close(torch.cat([a, b], 1).numpy(), whole.numpy())
    _close(bst.h.numpy(), wst.h.numpy())
    assert torch.equal(bst.conv, wst.conv)
    # and the JAX package's two segments, from the port's carried state
    jb, _ = _jit_block(jrec.rglru_block, jc, "prefill")(
        jp, jx[:, 10:], jrec.RGLRUState(h=jnp.asarray(ast.h.numpy()),
                                        conv=jnp.asarray(ast.conv.numpy())))
    _close(b.numpy(), jb)


def test_rglru_scan_matches_associative_scan(rng):
    """The doubling scan at lengths around powers of two."""
    for S in (1, 2, 7, 8, 33):
        a = rng.uniform(0.5, 1.0, (2, S, 5)).astype(np.float32)
        u = rng.standard_normal((2, S, 5)).astype(np.float32)
        h0 = rng.standard_normal((2, 5)).astype(np.float32)
        wh, wl = jax.jit(jrec._rglru_scan)(jnp.asarray(u), jnp.asarray(a),
                                           jnp.asarray(h0))
        gh, gl = trec._rglru_scan(_t(u), _t(a), _t(h0))
        _close(gh.numpy(), wh)
        _close(gl.numpy(), wl)


def test_rglru_init_follows_reference_distributions():
    """The port's own draws: Lambda so that a^c lies in [0.9, 0.999] at
    r = 1, the conv N(0, 0.1)."""
    tc = treg.get_config("recurrentgemma-2b")
    p = trec.init_rglru(tc, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    a_c = torch.exp(-trec.RGLRU_C * torch.nn.functional.softplus(p.lam))
    assert float(a_c.min()) >= 0.9 ** 2 - 1e-6
    assert float(a_c.max()) <= 0.999 ** 2 + 1e-6
    assert abs(float(p.conv_w.std()) - 0.1) < 0.01
    assert p.lam.shape == (2560,) and p.conv_w.shape == (4, 2560)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def _rwkv_pair(seed=0):
    jc, tc = _cfgs("rwkv6-7b")
    jp = jrec.init_rwkv(jax.random.PRNGKey(seed), jc)
    n = _np(jp)
    tp = trec.RWKV(**{k: (_lin(v) if isinstance(v, dict) else _t(v))
                      for k, v in n.items()})
    return jc, tc, jp, tp


def _wkv_inputs(rng, B, S, H, D, decay=-2.0):
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, D)) + decay).astype(
        np.float32)
    u = (0.5 * rng.standard_normal((H, D))).astype(np.float32)
    s0 = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("S,chunk", [(64, 64), (48, 16), (5, 5), (1, 1)])
def test_wkv_chunked_matches_reference(rng, S, chunk):
    ins = _wkv_inputs(rng, 2, S, 3, 16)
    wo, ws = jax.jit(jrec._wkv_chunked, static_argnames="chunk")(
        *map(jnp.asarray, ins), chunk=chunk)
    go, gs = trec._wkv_chunked(*map(_t, ins), chunk=chunk)
    scale = max(1.0, float(np.abs(np.asarray(wo)).max()))
    _close(go.numpy() / scale, np.asarray(wo) / scale)
    _close(gs.numpy() / scale, np.asarray(ws) / scale)


def test_wkv_chunked_keeps_the_chunk_assert(rng):
    ins = _wkv_inputs(rng, 1, 10, 1, 16)
    with pytest.raises(AssertionError):
        trec._wkv_chunked(*map(_t, ins), chunk=4)


@pytest.mark.parametrize("decay", [-2.0, -8.0])
def test_wkv_chunked_matches_kernel_plain_version_from_zero_state(rng, decay):
    """From a zero state the chunked form is the ``wkv_recurrent``
    recurrence (its plain version on the CPU: the kernel's wrapper takes
    it for CPU tensors); its last state is the step-by-step state."""
    B, S, H, D = 2, 128, 2, 16
    r, k, v, logw, u, _ = _wkv_inputs(rng, B, S, H, D, decay)
    s0 = torch.zeros((B, H, D, D))
    o, s_last = trec._wkv_chunked(_t(r), _t(k), _t(v), _t(logw), _t(u), s0)

    def fold(a):  # (B, S, H, D) -> (B*H, S, D), contiguous
        return _t(a).permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()

    want = wkv_recurrent(fold(r), fold(k), fold(v), fold(logw),
                         _t(u).repeat(B, 1))
    assert torch.equal(want, wkv_recurrent_plain(fold(r), fold(k), fold(v),
                                                 fold(logw),
                                                 _t(u).repeat(B, 1)))
    got = o.permute(0, 2, 1, 3).reshape(B * H, S, D)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale
    s = torch.zeros((B, H, D, D))
    for t in range(S):
        kt, vt = _t(k[:, t]), _t(v[:, t])
        s = torch.exp(_t(logw[:, t]))[..., None] * s \
            + kt[..., None] * vt[:, :, None, :]
    assert float((s_last - s).abs().max()) <= TOL * float(s.abs().max())


@pytest.mark.parametrize("S", [1, 16, 64])
def test_rwkv_time_and_channel_mix_match_reference(rng, S):
    jc, tc, jp, tp = _rwkv_pair()
    B, d = 2, jc.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    jst = jrec.RWKVState(
        s=jnp.asarray(rng.standard_normal((B, d // 16, 16, 16))
                      .astype(np.float32)),
        tm_last=jnp.asarray(rng.standard_normal((B, d)).astype(np.float32)),
        cm_last=jnp.asarray(rng.standard_normal((B, d)).astype(np.float32)))
    tst = trec.RWKVState(*(_t(np.asarray(a)) for a in jst))
    modes = ("prefill", "decode") if S == 1 else ("prefill",)
    for mode in modes:
        for state in ((None, None), (jst, tst)):
            want, jn = _jit_block(jrec.rwkv_time_mix, jc, mode)(
                jp, jnp.asarray(x), state[0])
            got, tn = trec.rwkv_time_mix(tp, tc, _t(x), F32, mode=mode,
                                         state=state[1])
            _close(got.numpy(), want)
            _close(tn.s.numpy(), jn.s)
            _close(tn.tm_last.numpy(), jn.tm_last)
        last = (None, None), (jst.cm_last, tst.cm_last)
        for jl, tl in last:
            want, jnl = jax.jit(lambda p, x, last: jrec.rwkv_channel_mix(
                p, jc, x, jnp.float32, mode=mode, last=last))(
                    jp, jnp.asarray(x), jl)
            got, tnl = trec.rwkv_channel_mix(tp, tc, _t(x), F32, mode=mode,
                                             last=tl)
            _close(got.numpy(), want)
            _close(tnl.numpy(), jnl)


def test_rwkv_decode_steps_continue_the_chunked_prefill(rng):
    """Prefill 32 tokens, then 4 exact single steps, against one chunked
    pass over the 36 (chunk 4), through the port's own block."""
    jc, tc, jp, tp = _rwkv_pair(seed=5)
    x = _t(rng.standard_normal((2, 36, jc.d_model)).astype(np.float32))
    whole, _ = trec.rwkv_time_mix(tp, tc, x, F32, mode="prefill")
    out, st = trec.rwkv_time_mix(tp, tc, x[:, :32], F32, mode="prefill")
    steps = []
    for i in range(32, 36):
        o, st = trec.rwkv_time_mix(tp, tc, x[:, i:i + 1], F32, mode="decode",
                                   state=st)
        steps.append(o)
    _close(torch.cat([out] + steps, 1).numpy(), whole.numpy())


# ---------------------------------------------------------------------------
# Codebooks and frontends
# ---------------------------------------------------------------------------

def _model_pair(arch):
    jc, tc = _cfgs(arch)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, lm_params_from_numpy(tc, _np(jp), device="cpu")


def test_codebook_embed_and_unembed_match_reference(rng):
    jc, tc, jp, model = _model_pair("musicgen-medium")
    assert jc.num_codebooks == 4 and len(model.embed) == 4
    toks = rng.integers(0, jc.vocab_size, (2, 5, 4)).astype(np.int32)
    want = jax.jit(lambda p, t: jtf.embed_tokens(p, jc, t))(
        jp, jnp.asarray(toks))
    got = ttf.embed_tokens(model, tc, torch.from_numpy(toks).long())
    _close(got.numpy(), want, tol=1e-7)
    h = rng.standard_normal((2, 3, jc.d_model)).astype(np.float32)
    jl = jax.jit(lambda p, h: jtf.unembed(p, jc, h))(jp, jnp.asarray(h))
    tl = ttf.unembed(model, tc, _t(h))
    assert isinstance(tl, tuple) and len(tl) == 4
    for a, b in zip(tl, jl):
        assert a.shape == (2, 3, jc.vocab_size)
        _close(a.numpy(), b)
    # tied codebook embeddings: the transposed tables
    jt = dataclasses.replace(jc, tie_embeddings=True)
    tt = dataclasses.replace(tc, tie_embeddings=True)
    jpt = jtf.init_params(jt, jax.random.PRNGKey(1))
    mt = lm_params_from_numpy(tt, _np(jpt), device="cpu")
    assert mt.head is None
    jlt = jax.jit(lambda p, h: jtf.unembed(p, jt, h))(jpt, jnp.asarray(h))
    for a, b in zip(ttf.unembed(mt, tt, _t(h)), jlt):
        _close(a.numpy(), b)


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-medium"])
def test_frontend_goes_in_front_of_the_tokens(rng, arch):
    """The (B, F, d) stub embeddings take the first F positions: the
    forward's output and prefill state's ``pos`` = F + S, as the
    reference's."""
    jc, tc, jp, model = _model_pair(arch)
    F = jc.frontend.num_positions
    B, S = 2, 6
    shape = (B, S) + ((4,) if jc.num_codebooks > 1 else ())
    toks = rng.integers(0, jc.vocab_size, shape).astype(np.int32)
    fe = rng.standard_normal((B, F, jc.d_model)).astype(np.float32)
    jx, jst, _ = jax.jit(lambda p, b: jtf.forward(
        p, jc, b, mode="prefill", remat="none"))(
            jp, {"tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)})
    with torch.inference_mode():
        tx, tst, _ = ttf.forward(model, tc, {
            "tokens": torch.from_numpy(toks).long(),
            "frontend": _t(fe)}, mode="prefill")
    assert tx.shape == (B, F + S, jc.d_model)
    _close(tx.numpy(), jx)
    assert tst["pos"] == int(jst["pos"]) == F + S
    # the frontend changes what the tokens see
    with torch.inference_mode():
        t0, _, _ = ttf.forward(model, tc, {
            "tokens": torch.from_numpy(toks).long(),
            "frontend": torch.zeros_like(_t(fe))}, mode="prefill")
    assert not torch.allclose(t0[:, F:], tx[:, F:])
