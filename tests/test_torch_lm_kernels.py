"""The LM kernels' plain versions against the JAX package, on the CPU.

``flash_attention`` and ``wkv_recurrent`` of the port take their plain
torch versions on CPU tensors (their CUDA kernels run only on the card:
tests/test_torch_cuda.py).  Each is held, on the same numpy inputs,
against the reference oracle in ``repro/kernels/ref.py`` and against the
Pallas kernel in interpret mode (these two use no ``pl.load``, so they
run under this jax; ROADMAP.md H1), at the JAX tests' own bars: flash
2e-5 in float32 and 5e-2 in bfloat16, wkv 2e-5 against the recurrence
and 3e-4 against the model's chunked algebra.

The bf16 flash kernel rounds P to bf16 on the tensor cores, so on the card
it is held to the two-part bar of ``flash_attn.bf16_error`` instead of one
ulp.  Here an emulation of its rounding points in plain torch shows, against
the reference oracle, that the bar admits that rounding and rejects a
dropped kv tile or a causal mask off by one.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.wkv import wkv_recurrent as j_wkv
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import (bf16_error, flash_attention,
                                            flash_attention_plain)
from repro_torch.kernels.wkv import wkv_recurrent, wkv_recurrent_plain

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    a = rng.standard_normal(shape)
    return jnp.asarray(a, jdt), torch.tensor(a, dtype=torch.float32).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("BH,S,D", [(4, 256, 64), (2, 384, 128), (1, 128, 64),
                                    (3, 200, 64)])
def test_flash_plain_matches_reference_causal(rng, BH, S, D, dtype):
    tol = DTYPES[dtype][2]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (BH, S, D), dtype)
                                    for _ in range(3))
    got = ops.flash_mha(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and tuple(got.shape) == (BH, S, D)
    want = ref.flash_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    pallas = jops.flash_mha(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)


def test_flash_plain_non_causal(rng):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, 256, 64), "float32")
                                    for _ in range(3))
    got = ops.flash_mha(tq, tk, tv, causal=False)
    want = ref.flash_attention_ref(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)
    pallas = jops.flash_mha(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-5)


def test_h12_reference_pads_keys_into_non_causal_softmax(rng):
    """ROADMAP.md H12: at a ragged S the reference's ``flash_mha`` zero-pads
    k and v to 128 rows, and without the causal mask the padded keys join
    the softmax.  The port masks against the true S, as ``ref.py`` does."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, 200, 64), "float32")
                                    for _ in range(3))
    want = _f32(ref.flash_attention_ref(jq, jk, jv, causal=False))
    got = _f32(flash_attention(tq, tk, tv, causal=False))
    np.testing.assert_allclose(got, want, atol=2e-5)
    pallas = _f32(jops.flash_mha(jq, jk, jv, causal=False))
    assert np.abs(pallas - want).max() > 1e-2


def test_flash_plain_is_the_wrapper_on_cpu(rng):
    _, q = _pair(rng, (2, 64, 64), "float32")
    ops.reset_launch_counts()
    for causal in (True, False):
        assert torch.equal(flash_attention(q, q, q, causal),
                           flash_attention_plain(q, q, q, causal))
    assert ops.launch_counts()["flash_attention"] == 0


def _emulate_tc(q, k, v, causal, drop_tile=None, mask_shift=0, tile=64):
    """The bf16 kernel's rounding points in plain torch: bf16 q/k/v, fp32
    scores per 64-key tile, the online softmax in fp32 with the scale folded
    into exp2, each tile's P rounded to bf16 before an fp32 P V product, row
    sums of the unrounded P, a bf16 output.  ``drop_tile`` skips one kv tile
    and ``mask_shift`` moves the causal mask: faults the bar must catch."""
    BH, S, D = q.shape
    sl = math.log2(math.e) / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((BH, S, 1), -math.inf)
    l = torch.zeros(BH, S, 1)
    acc = torch.zeros(BH, S, D)
    rows = torch.arange(S)[:, None]
    for j in range(0, S, tile):
        if j // tile == drop_tile:
            continue
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, j:j + tile])
        if causal:
            cols = torch.arange(j, min(j + tile, S))[None, :]
            s = torch.where(cols <= rows + mask_shift, s, -math.inf)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        ms = torch.where(mx == -math.inf, 0.0, mx * sl)
        corr = torch.exp2(m * sl - ms)
        p = torch.exp2(s * sl - ms)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bqk,bkd->bqd", p.bfloat16().float(), vf[:, j:j + tile])
        m = mx
    return (acc / l).bfloat16()


def _bf16_oracle(rng, BH, S, D, causal):
    """bf16 q, k, v and the reference oracle on their values in float32."""
    qkv = [torch.tensor(rng.standard_normal((BH, S, D)),
                        dtype=torch.float32).bfloat16() for _ in range(3)]
    want = ref.flash_attention_ref(*(jnp.asarray(t.float().numpy())
                                     for t in qkv), causal=causal)
    return qkv, torch.tensor(np.asarray(want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,D", [(4, 256, 64), (2, 384, 128)])
def test_flash_bf16_bar_admits_the_kernels_rounding(rng, BH, S, D, causal):
    (q, k, v), want = _bf16_oracle(rng, BH, S, D, causal)
    elem, rms = bf16_error(_emulate_tc(q, k, v, causal), want, v)
    assert elem <= 1.0 and rms <= 1.0, (elem, rms)
    # the plain version's bf16 output (fp32 P) passes it too
    elem, rms = bf16_error(flash_attention(q, k, v, causal), want, v)
    assert elem <= 1.0 and rms <= 1.0, (elem, rms)


@pytest.mark.parametrize("BH,S,D,causal,fault", [
    (4, 256, 64, True, "drop"), (4, 256, 64, True, "shift"),
    (2, 384, 128, True, "drop"), (2, 384, 128, True, "shift"),
    (4, 256, 64, False, "drop"), (2, 384, 128, False, "drop")])
def test_flash_bf16_bar_rejects_a_dropped_tile_or_shifted_mask(
        rng, BH, S, D, causal, fault):
    (q, k, v), want = _bf16_oracle(rng, BH, S, D, causal)
    kw = {"drop_tile": 1} if fault == "drop" else {"mask_shift": 1}
    elem, rms = bf16_error(_emulate_tc(q, k, v, causal, **kw), want, v)
    assert elem > 1.0 or rms > 1.0, (elem, rms)


def test_flash_bf16_bar_fails_nan():
    """A row with no key (tile 0 dropped under the causal mask) is 0/0: NaN
    must fail the bar, not slip past a comparison."""
    rng = np.random.default_rng(3)
    (q, k, v), want = _bf16_oracle(rng, 1, 128, 64, True)
    elem, rms = bf16_error(_emulate_tc(q, k, v, True, drop_tile=0), want, v)
    assert not (elem <= 1.0 and rms <= 1.0)


def _wkv_inputs(rng, BH, T, D):
    r, k, v = (rng.standard_normal((BH, T, D)) for _ in range(3))
    logw = -np.exp(rng.standard_normal((BH, T, D)) - 2.0)  # <= 0
    u = 0.3 * rng.standard_normal((BH, D))
    arrs = [a.astype(np.float32) for a in (r, k, v, logw, u)]
    return ([jnp.asarray(a) for a in arrs],
            [torch.tensor(a) for a in arrs])


@pytest.mark.parametrize("BH,T,D", [(2, 64, 16), (3, 96, 32), (1, 128, 64)])
def test_wkv_plain_matches_reference(rng, BH, T, D):
    jin, tin = _wkv_inputs(rng, BH, T, D)
    got = ops.wkv_recurrent(*tin)
    assert got.dtype == torch.float32 and tuple(got.shape) == (BH, T, D)
    want = ref.wkv_recurrent_ref(*jin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    pallas = j_wkv(*jin, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5,
                               atol=2e-5)


def test_wkv_plain_matches_model_chunked_algebra(rng):
    from repro.models.recurrent import _wkv_chunked

    B, T, H, D = 2, 128, 2, 16
    r, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    logw = (-np.exp(rng.standard_normal((B, T, H, D)) - 2.0)).astype(
        np.float32)
    u = (0.3 * rng.standard_normal((H, D))).astype(np.float32)
    o_chunk, _ = _wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                              jnp.zeros((B, H, D, D)), chunk=32)

    def fold(a):
        return torch.tensor(a).transpose(1, 2).reshape(B * H, T, D)

    got = wkv_recurrent(fold(r), fold(k), fold(v), fold(logw),
                        torch.tensor(np.tile(u, (B, 1))))
    got = got.reshape(B, H, T, D).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(o_chunk), rtol=3e-4,
                               atol=3e-4)


def test_wkv_plain_finite_at_decay_bounds(rng):
    BH, T, D = 1, 256, 8
    _, (r, k, v, _, u) = _wkv_inputs(rng, BH, T, D)
    ops.reset_launch_counts()
    for scale in (-8.0, -1e-4):
        logw = torch.full((BH, T, D), scale)
        o = wkv_recurrent(r, k, v, logw, u)
        assert bool(torch.isfinite(o).all())
        assert torch.equal(o, wkv_recurrent_plain(r, k, v, logw, u))
    assert ops.launch_counts()["wkv_recurrent"] == 0


def test_wkv_plain_widens_bf16_inputs(rng):
    _, tin = _wkv_inputs(rng, 2, 32, 16)
    bf = [t.to(torch.bfloat16) for t in tin]
    got = wkv_recurrent(*bf)
    assert got.dtype == torch.float32
    assert torch.equal(got, wkv_recurrent_plain(*(t.float() for t in bf)))
