"""The port's LM serving path against the JAX package, on the CPU.

Both packages get the same weights (the JAX ``init_params`` tree carried
across by ``convert.lm_params_from_numpy``) and the same numpy tokens.
In float32 compute, where the algorithm is the point, the prefill logits
agree to 2e-5 absolute (logits of order 0.1-1; the two differ only in
summation order and in the last bits of exp/sin/cos) and six greedy decode
steps give the same tokens with logits to the same bar.  In bfloat16
compute, XLA and torch round at other places (after each einsum, in the
rope concat), so the port is held to the JAX package's own bf16 bars
(tests/test_models_smoke.py: |diff| <= 0.15, argmax agreement >= 0.5).
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import base as jbase
from repro.launch.serve import prefill_to_decode_state as j_prefill_to_decode
from repro.models import attention as jatt
from repro.models import layers as jlay
from repro.models import transformer as jtf
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ATTN, ATTN_LOCAL, RECURRENT, RWKV
from repro_torch.convert import layers_in_order, lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import prefill_to_decode_state, serve
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlay
from repro_torch.models import transformer as ttf

DENSE = ("qwen3-1.7b", "minitron-8b", "starcoder2-15b", "command-r-plus-104b")
F32_TOL = 2e-5
BF16_TOL = 0.15
DECODE_STEPS = 6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _cfgs():
    """(label, JAX config, port config): the dense smoke configs, and a
    qwen3 smoke with a local-attention pattern and a remainder layer."""
    out = [(a, jreg.smoke_config(a), treg.smoke_config(a)) for a in DENSE]
    kw = dict(block_pattern=(ATTN, ATTN_LOCAL), window=8, num_layers=5)
    out.append(("qwen3-local",
                dataclasses.replace(jreg.smoke_config("qwen3-1.7b"), **kw),
                dataclasses.replace(treg.smoke_config("qwen3-1.7b"), **kw)))
    return out


CFGS = {label: (jc, tc) for label, jc, tc in _cfgs()}


def _pair(label, dtype, seed=0):
    jc, tc = CFGS[label]
    jc = dataclasses.replace(jc, dtype=dtype)
    tc = dataclasses.replace(tc, dtype=dtype)
    jparams = jtf.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jparams, lm_params_from_numpy(tc, _np_tree(jparams),
                                                 device="cpu")


def _tokens(cfg, B=2, S=16, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _jax_serve(jc, jparams, toks, steps):
    """The JAX package's prefill -> prefill_to_decode_state -> decode_step
    loop (greedy); returns the prefill logits, tokens and step logits."""
    logits, st = jax.jit(lambda p, b: jtf.prefill(p, jc, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    st = j_prefill_to_decode(jc, st, toks.shape[1] + steps)
    dfn = jax.jit(lambda p, s, t: jtf.decode_step(p, jc, s, t))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    out_toks, out_logits = [np.asarray(tok)], []
    for _ in range(steps - 1):
        st, lg = dfn(jparams, st, tok)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
        out_toks.append(np.asarray(tok))
        out_logits.append(np.asarray(lg[:, -1], np.float32))
    return np.asarray(logits[:, -1], np.float32), out_toks, out_logits


@torch.inference_mode()
def _port_serve(tc, params, toks, steps):
    logits, st = ttf.prefill(params, tc, {"tokens": torch.from_numpy(
        toks).long()})
    st = prefill_to_decode_state(tc, st, toks.shape[1] + steps)
    tok = torch.argmax(logits[:, -1], -1)
    out_toks, out_logits = [tok.numpy()], []
    for _ in range(steps - 1):
        st, lg = ttf.decode_step(params, tc, st, tok)
        tok = torch.argmax(lg[:, -1], -1)
        out_toks.append(tok.numpy())
        out_logits.append(lg[:, -1].float().numpy())
    return logits[:, -1].float().numpy(), out_toks, out_logits


# ---------------------------------------------------------------------------
# Configs: a copy of the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.list_archs())
def test_configs_are_the_reference_configs(arch):
    assert treg.list_archs() == jreg.list_archs()
    for get in ("get_config", "smoke_config"):
        t, j = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.layer_kinds() == j.layer_kinds()
        assert t.param_counts() == j.param_counts()


def test_parse_overrides_and_shapes_match_reference():
    s = "attn_kernel=True,dense_attn_max_seq=2048,ce_impl=onehot"
    assert tbase.parse_overrides(s) == jbase.parse_overrides(s)
    assert tbase.parse_overrides("") == {}
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert treg.cells() == jreg.cells()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_layers_match_reference(rng):
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    for theta in (1e4, 1e6):
        got = tlay.rope(_t(x), torch.from_numpy(pos), theta)
        want = jlay.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    scale = rng.standard_normal(16).astype(np.float32)
    got = tlay.rms_norm(tlay.RMSNorm(_t(scale)), _t(x), 1e-6)
    want = jlay.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)
    got = tlay.sinusoidal_positions(torch.from_numpy(pos), 16, torch.float32)
    want = jlay.sinusoidal_positions(jnp.asarray(pos), 16, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    for gated in (True, False):
        jp = _np_tree(jlay.init_mlp(jax.random.PRNGKey(1), 16, 24, gated,
                                    jnp.float32, use_bias=True))
        tp = tlay.MLP(*(tlay.Linear(_t(jp[n]["w"]), _t(jp[n]["b"]))
                        if n in jp else None for n in ("up", "down", "gate")))
        got = tlay.mlp(tp, _t(h), gated, torch.float32)
        want = jlay.mlp(jp, jnp.asarray(h), gated, jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


# ---------------------------------------------------------------------------
# Attention routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2)])
def test_kernel_attend_matches_dense_attend(rng, H, KV):
    """The port's kernel route (its plain version on the CPU) against the
    JAX dense path, MHA and GQA, at the reference test's 3e-5."""
    B, S, D = 2, 128, 64
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    pos = np.arange(S)
    want = jatt._dense_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(pos), 0, 0.0)
    got = tatt._kernel_attend(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0),
                                            (24, 30.0)])
def test_dense_and_chunked_attend_match_reference(rng, window, softcap):
    B, S, H, KV, D = 2, 64, 4, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    tq, tk, tv, tp = _t(q), _t(k), _t(v), torch.from_numpy(pos)
    dense = jatt._dense_attend(jq, jk, jv, jp, jp, window, softcap)
    got = tatt._dense_attend(tq, tk, tv, tp, tp, window, softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=2e-6)
    chunked = jatt._flash_attend(jq, jk, jv, jp, jp, window, softcap,
                                 q_chunk=16, kv_chunk=32)
    got = tatt._flash_attend(tq, tk, tv, tp, tp, window, softcap,
                             q_chunk=16, kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(chunked), atol=2e-6)
    # attend() above dense_max takes the chunked route, as the reference
    got = tatt.attend(tq, tk, tv, tp, tp, window, softcap, dense_max=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=2e-6)


def test_attend_takes_kernel_only_on_cuda(rng):
    """On CPU tensors ``use_kernel`` leaves the dense route in place (the
    reference's backend test); no launch is counted."""
    B, S, H, D = 1, 32, 2, 64
    q = _t(rng.standard_normal((B, S, H, D)))
    pos = torch.arange(S)
    ops.reset_launch_counts()
    got = tatt.attend(q, q, q, pos, pos, use_kernel=True)
    want = tatt._dense_attend(q, q, q, pos, pos, 0, 0.0)
    assert torch.equal(got, want)
    assert ops.launch_counts()["flash_attention"] == 0


def test_qwen3_attention_widths_through_flash_route(rng):
    """qwen3-1.7b's attention widths (d_model 2048, 16 query / 8 KV heads
    of 128) at S = 256, so the reference's Pallas route spans two 128-row
    blocks: the port's kernel route (plain version here) against the JAX
    kernel route (interpret mode) and the JAX dense path, with the layer's
    real projections from JAX-initialised weights."""
    cfg = jreg.get_config("qwen3-1.7b")
    jc = dataclasses.replace(cfg, dtype="float32")
    tc = dataclasses.replace(treg.get_config("qwen3-1.7b"), dtype="float32")
    jp = jatt.init_attention(jax.random.PRNGKey(0), jc)
    x = rng.standard_normal((1, 256, cfg.d_model)).astype(np.float32)
    pos = np.arange(256, dtype=np.int32)
    q, k, v = jatt._qkv(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                        jnp.float32)
    assert q.shape == (1, 256, 16, 128) and k.shape == (1, 256, 8, 128)
    want = jatt._dense_attend(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                              0, 0.0)
    want_kernel = jatt._kernel_attend(q, k, v)
    np.testing.assert_allclose(np.asarray(want_kernel), np.asarray(want),
                               atol=3e-5)
    npj = _np_tree(jp)
    tp = tatt.Attention(*(tlay.Linear(_t(npj[n]["w"])) for n in
                          ("wq", "wk", "wv", "wo")),
                        tlay.RMSNorm(_t(npj["qnorm"]["scale"])),
                        tlay.RMSNorm(_t(npj["knorm"]["scale"])))
    tq, tk, tv = tatt._qkv(tp, tc, _t(x), torch.from_numpy(pos),
                           torch.float32)
    np.testing.assert_allclose(tq.numpy(), np.asarray(q), atol=2e-5)
    got = tatt._kernel_attend(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_params_unstack_in_layer_order():
    """Scanned groups first (layer g * len(pattern) + i is leaf [g] of
    pattern position i), then the remainder layers."""
    jc, tc, jparams, model = _pair("qwen3-local", "float32")
    tree = _np_tree(jparams)
    assert tc.layer_kinds() == (ATTN, ATTN_LOCAL, ATTN, ATTN_LOCAL, ATTN)
    assert [b.kind for b in model.blocks] == list(tc.layer_kinds())
    scan = tree["blocks"]["scan"]
    for layer, blk in enumerate(model.blocks):
        if layer < 4:
            want = scan[layer % 2]["attn"]["wq"]["w"][layer // 2]
        else:
            want = tree["blocks"]["rem"][0]["attn"]["wq"]["w"]
        np.testing.assert_array_equal(blk.attn.wq.w.numpy(), want)
    np.testing.assert_array_equal(model.embed.numpy(),
                                  tree["embed"]["tokens"])


@pytest.mark.parametrize("label", list(CFGS))
def test_prefill_and_greedy_decode_match_reference_f32(label):
    jc, tc, jparams, model = _pair(label, "float32")
    toks = _tokens(jc)
    j_logits, j_toks, j_steps = _jax_serve(jc, jparams, toks, DECODE_STEPS)
    t_logits, t_toks, t_steps = _port_serve(tc, model, toks, DECODE_STEPS)
    np.testing.assert_allclose(t_logits, j_logits, atol=F32_TOL)
    for step, (a, b) in enumerate(zip(t_toks, j_toks)):
        np.testing.assert_array_equal(a, b, err_msg=f"token {step}")
    for a, b in zip(t_steps, j_steps):
        np.testing.assert_allclose(a, b, atol=F32_TOL)


def test_prefill_caches_match_reference_f32():
    jc, tc, jparams, model = _pair("qwen3-local", "float32")
    toks = _tokens(jc)
    _, jst = jtf.prefill(jparams, jc, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        _, tst = ttf.prefill(model, tc, {"tokens": torch.from_numpy(toks)
                                         .long()})
    assert tst["pos"] == int(jst["pos"]) == toks.shape[1]
    jlayers = layers_in_order(jc, _np_tree(jst))
    assert len(jlayers) == len(tst["layers"]) == jc.num_layers
    for js, ts in zip(jlayers, tst["layers"]):
        np.testing.assert_allclose(ts.k.numpy(), js.k, atol=2e-5)
        np.testing.assert_allclose(ts.v.numpy(), js.v, atol=2e-5)
    padded = prefill_to_decode_state(tc, tst, toks.shape[1] + 4)
    assert padded["layers"][0].k.shape[1] == toks.shape[1] + 4
    assert torch.equal(padded["layers"][0].k[:, :toks.shape[1]],
                       tst["layers"][0].k)
    assert not padded["layers"][0].k[:, toks.shape[1]:].any()


@pytest.mark.parametrize("label", list(CFGS))
def test_bf16_holds_reference_bars(label):
    """bf16 compute: the port's prefill against the JAX package's, and the
    port's token-by-token decode (ring-buffer caches from
    init_decode_state) against its own prefill, at the JAX bf16 bars."""
    jc, tc, jparams, model = _pair(label, "bfloat16", seed=2)
    toks = _tokens(jc)
    j_logits, _ = jax.jit(lambda p, b: jtf.prefill(p, jc, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    jl = np.asarray(j_logits[:, -1], np.float32)
    with torch.inference_mode():
        t_logits, _ = ttf.prefill(model, tc, {"tokens": torch.from_numpy(
            toks).long()})
        st = ttf.init_decode_state(tc, toks.shape[0], toks.shape[1],
                                   device="cpu")
        for i in range(toks.shape[1]):
            st, ld = ttf.decode_step(model, tc, st,
                                     torch.from_numpy(toks[:, i]).long())
    tl = t_logits[:, -1].float().numpy()
    ld = ld[:, -1].float().numpy()
    for a, b in ((tl, jl), (ld, tl)):
        np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL)
        assert np.mean(np.argmax(a, -1) == np.argmax(b, -1)) >= 0.5


def test_serve_on_cpu_returns_tokens_and_latency():
    cfg = treg.smoke_config("qwen3-1.7b")
    lines = []
    out = serve(cfg, batch=2, prompt_len=8, decode_steps=4, device="cpu",
                progress=lines.append)
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["tokens"].dtype == torch.int64
    assert int(out["tokens"].max()) < cfg.vocab_size
    assert out["step_latency"]["n"] == 3
    assert set(out["step_latency"]) == {"n", "mean", "p50", "p99", "p999",
                                        "max"}
    assert out["t_prefill"] > 0 and out["t_decode"] > 0
    assert tuple(out["logits"].shape) == (2, 1, cfg.vocab_size)
    assert all(v == 0 for v in out["launches"]["prefill"].values())
    assert lines and lines[0].startswith("[serve] prefill 8 toks x2")


def test_serve_is_deterministic_and_main_parses_overrides():
    from repro_torch.launch.serve import main
    cfg = treg.smoke_config("starcoder2-15b")
    a = serve(cfg, batch=1, prompt_len=4, decode_steps=3, device="cpu",
              progress=lambda s: None)
    b = main(["--arch", "starcoder2-15b", "--smoke", "--batch", "1",
              "--prompt-len", "4", "--decode-steps", "3", "--device", "cpu",
              "--overrides", "attn_kernel=True"])
    assert torch.equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("arch", jreg.list_archs())
def test_every_family_builds_and_prefills(arch):
    """All ten configs: the port's ``init_params`` at smoke size builds
    the layer kinds ``cfg.layer_kinds()`` names (with the FFN the config
    asks for), and a one-token prefill is finite."""
    cfg = treg.smoke_config(arch)
    model = ttf.init_params(cfg, device="cpu")
    assert tuple(b.kind for b in model.blocks) == cfg.layer_kinds()
    mixer = {ATTN: "attn", ATTN_LOCAL: "attn", RECURRENT: "rec", RWKV: "tm"}
    for b in model.blocks:
        assert getattr(b, mixer[b.kind]) is not None
        if b.kind != RWKV:
            assert (b.moe is not None) == (cfg.moe is not None)
    ncb = cfg.num_codebooks
    toks = torch.zeros((2, 1) + ((ncb,) if ncb > 1 else ()),
                       dtype=torch.long)
    batch = {"tokens": toks}
    if cfg.frontend is not None:
        batch["frontend"] = torch.zeros(
            (2, cfg.frontend.num_positions, cfg.d_model))
    with torch.inference_mode():
        logits, st = ttf.prefill(model, cfg, batch)
    logits = logits if ncb > 1 else (logits,)
    assert len(logits) == ncb
    for lg in logits:
        assert tuple(lg.shape) == (2, 1, cfg.vocab_size)
        assert bool(torch.isfinite(lg.float()).all())
    F = cfg.frontend.num_positions if cfg.frontend is not None else 0
    assert st["pos"] == F + 1 and len(st["layers"]) == cfg.num_layers
