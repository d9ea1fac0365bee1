"""The six LM families beyond dense attention, served end to end by the
port and by the JAX package, on the CPU.

olmoe-1b-7b and arctic-480b (MoE, arctic with its dense residual),
recurrentgemma-2b (RG-LRU + local attention), rwkv6-7b (RWKV-6),
musicgen-medium (4 codebooks, a frame frontend) and pixtral-12b (a patch
frontend) at their smoke widths.  Both packages get the same weights (the
JAX ``init_params`` tree carried across by ``lm_params_from_numpy``), the
same numpy prompt and frontend, and go through their own prefill,
``prefill_to_decode_state`` and decode steps, greedy, as each package's
``serve`` does.  In float32 the prefill logits and six decode
steps' logits agree to 2e-5 and the tokens are the same; in bfloat16 the
port is held to the JAX package's bf16 bars (|diff| <= 0.15, argmax
agreement >= 0.5; tests/test_models_smoke.py).
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.serve import prefill_to_decode_state as j_prefill_to_decode
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.convert import layers_in_order, lm_params_from_numpy
from repro_torch.launch.serve import (greedy, main, prefill_to_decode_state,
                                      serve)
from repro_torch.models import transformer as ttf
from repro_torch.models.attention import AttnState

FAMILIES = ("olmoe-1b-7b", "arctic-480b", "recurrentgemma-2b", "rwkv6-7b",
            "musicgen-medium", "pixtral-12b")
F32_TOL = 2e-5
BF16_TOL = 0.15
DECODE_STEPS = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, dtype, seed=0):
    jc = dataclasses.replace(jreg.smoke_config(arch), dtype=dtype)
    tc = dataclasses.replace(treg.smoke_config(arch), dtype=dtype)
    jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, lm_params_from_numpy(tc, _np(jp), device="cpu")


def _inputs(cfg, B=2, S=16, seed=3):
    """numpy tokens (B, S[, ncb]) and, with a frontend, (B, F, d) floats."""
    g = np.random.default_rng(seed)
    shape = (B, S) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    toks = g.integers(0, cfg.vocab_size, shape).astype(np.int32)
    fe = None
    if cfg.frontend is not None:
        fe = g.standard_normal((B, cfg.frontend.num_positions, cfg.d_model)
                               ).astype(np.float32)
    return toks, fe


def _jbatch(toks, fe, dtype=jnp.float32):
    b = {"tokens": jnp.asarray(toks)}
    if fe is not None:
        b["frontend"] = jnp.asarray(fe).astype(dtype)
    return b


def _tbatch(toks, fe, dtype=torch.float32):
    b = {"tokens": torch.from_numpy(toks).long()}
    if fe is not None:
        b["frontend"] = torch.from_numpy(fe).to(dtype)
    return b


def _last(logits):
    """(B, V) float32 arrays of the last position, one per codebook."""
    lg = logits if isinstance(logits, tuple) else (logits,)
    return [np.asarray(jnp.asarray(x[:, -1], jnp.float32)) if
            isinstance(x, jax.Array) else x[:, -1].float().numpy()
            for x in lg]


def _jgreedy(lg):
    if isinstance(lg, tuple):
        return jnp.stack([jnp.argmax(x[:, -1], -1) for x in lg],
                         -1).astype(jnp.int32)
    return jnp.argmax(lg[:, -1], -1).astype(jnp.int32)


def _cache_len(cfg, S, steps):
    F = cfg.frontend.num_positions if cfg.frontend is not None else 0
    return S + steps + F


def _jax_serve(jc, jp, toks, fe, steps):
    logits, st = jax.jit(lambda p, b: jtf.prefill(p, jc, b))(
        jp, _jbatch(toks, fe))
    st = j_prefill_to_decode(jc, st, _cache_len(jc, toks.shape[1], steps))
    dfn = jax.jit(lambda p, s, t: jtf.decode_step(p, jc, s, t))
    tok = _jgreedy(logits)
    out_toks, out_logits = [np.asarray(tok)], []
    for _ in range(steps - 1):
        st, lg = dfn(jp, st, tok)
        tok = _jgreedy(lg)
        out_toks.append(np.asarray(tok))
        out_logits.append(_last(lg))
    return _last(logits), out_toks, out_logits


@torch.inference_mode()
def _port_serve(tc, model, toks, fe, steps):
    logits, st = ttf.prefill(model, tc, _tbatch(toks, fe))
    st = prefill_to_decode_state(tc, st, _cache_len(tc, toks.shape[1],
                                                    steps))
    tok = greedy(logits)
    out_toks, out_logits = [tok.numpy()], []
    for _ in range(steps - 1):
        st, lg = ttf.decode_step(model, tc, st, tok)
        tok = greedy(lg)
        out_toks.append(tok.numpy())
        out_logits.append(_last(lg))
    return _last(logits), out_toks, out_logits


def _bars(a, b):
    np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL)
    assert np.mean(np.argmax(a, -1) == np.argmax(b, -1)) >= 0.5


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_greedy_decode_match_reference_f32(arch):
    jc, tc, jp, model = _pair(arch, "float32")
    toks, fe = _inputs(jc)
    j_logits, j_toks, j_steps = _jax_serve(jc, jp, toks, fe, DECODE_STEPS)
    t_logits, t_toks, t_steps = _port_serve(tc, model, toks, fe,
                                            DECODE_STEPS)
    for a, b in zip(t_logits, j_logits):
        np.testing.assert_allclose(a, b, atol=F32_TOL)
    for step, (a, b) in enumerate(zip(t_toks, j_toks)):
        np.testing.assert_array_equal(a, b, err_msg=f"token {step}")
        assert a.shape == ((2, jc.num_codebooks) if jc.num_codebooks > 1
                           else (2,))
    for sa, sb in zip(t_steps, j_steps):
        for a, b in zip(sa, sb):
            np.testing.assert_allclose(a, b, atol=F32_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_holds_reference_bars(arch):
    """bf16 compute: the port's prefill against the JAX package's, and the
    port's prefill over the first half of the prompt followed by
    token-by-token decode of the second half against its own prefill
    over the whole, at the JAX bf16 bars."""
    jc, tc, jp, model = _pair(arch, "bfloat16", seed=2)
    toks, fe = _inputs(jc)
    j_logits, _ = jax.jit(lambda p, b: jtf.prefill(p, jc, b))(
        jp, _jbatch(toks, fe, jnp.bfloat16))
    S = toks.shape[1]
    with torch.inference_mode():
        t_logits, _ = ttf.prefill(model, tc, _tbatch(toks, fe,
                                                     torch.bfloat16))
        _, st = ttf.prefill(model, tc, _tbatch(toks[:, :S // 2], fe,
                                               torch.bfloat16))
        st = prefill_to_decode_state(tc, st, _cache_len(tc, S, 0))
        for i in range(S // 2, S):
            st, ld = ttf.decode_step(model, tc, st,
                                     torch.from_numpy(toks[:, i]).long())
    for tl, jl, dl in zip(_last(t_logits), _last(j_logits), _last(ld)):
        _bars(tl, jl)
        _bars(dl, tl)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_state_shapes_and_dtypes_match_reference(arch):
    """``init_decode_state`` and the prefill state, layer by layer, have
    the reference's leaf shapes and dtypes (KV caches, RG-LRU h in fp32
    and its conv tail, the RWKV state and token-shift rows); the
    prefill state pads only the attention caches."""
    jc, tc, jp, model = _pair(arch, "bfloat16")
    B, L = 2, 20
    jst = layers_in_order(jc, _np(jtf.init_decode_state(jc, B, L)))
    tst = ttf.init_decode_state(tc, B, L, device="cpu")
    assert tst["pos"] == 0 and len(tst["layers"]) == jc.num_layers
    for j, t in zip(jst, tst["layers"]):
        assert type(t).__name__ == type(j).__name__
        for name in t._fields:
            a, b = getattr(t, name), getattr(j, name)
            assert tuple(a.shape) == b.shape, (name, a.shape, b.shape)
            assert str(a.dtype)[6:] == str(b.dtype), (name, a.dtype, b.dtype)
            assert not a.any()
    toks, fe = _inputs(jc, B=B, S=8)
    with torch.inference_mode():
        _, pst = ttf.prefill(model, tc, _tbatch(toks, fe, torch.bfloat16))
    F = jc.frontend.num_positions if jc.frontend is not None else 0
    assert pst["pos"] == F + 8
    dst = prefill_to_decode_state(tc, pst, L + F)
    for a, b in zip(pst["layers"], dst["layers"]):
        if isinstance(a, AttnState):
            assert b.k.shape[1] == L + F
            assert torch.equal(b.k[:, :F + 8], a.k)
        else:
            assert b is a


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_on_cpu_is_deterministic(arch):
    cfg = treg.smoke_config(arch)
    a = serve(cfg, batch=2, prompt_len=8, decode_steps=4, device="cpu",
              progress=lambda s: None)
    ncb = cfg.num_codebooks
    want = (2, 4) + ((ncb,) if ncb > 1 else ())
    assert tuple(a["tokens"].shape) == want
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < \
        cfg.vocab_size
    logits = a["logits"] if ncb > 1 else (a["logits"],)
    assert len(logits) == ncb
    assert all(tuple(x.shape) == (2, 1, cfg.vocab_size) for x in logits)
    assert a["step_latency"]["n"] == 3
    assert all(v == 0 for v in a["launches"]["prefill"].values())
    b = main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
              "8", "--decode-steps", "4", "--device", "cpu"])
    assert torch.equal(a["tokens"], b["tokens"])
