"""The port's int8 wire quantizer (repro_torch/distributed/compression.py)
against the JAX package's (repro/distributed/compression.py).

Every function on the same numpy inputs, bit for bit, at float64,
float32 and bfloat16 (the arithmetic runs in the input's dtype in both
packages; the reference's ops run one by one here, each rounded): strips
(3, 16) and (k, 2h) = (2, 256), Gram rows (k, 6) and (7, 6) with and
without the preserved checksum entry, with and without error feedback,
and nested dict/list trees.  Then the reference's own algebra pins
(tests/test_precision.py): the scale floor, the error-feedback
telescoping, the per-row Gram scales and the preserve mask, and one
quantization a leaf (counted with a TorchFunctionMode over
``torch.round`` and ``torch.amax`` where the reference counts jaxpr
primitives).
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.distributed import compression as J
from repro_torch.distributed import compression as T

DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(3, 16), (2, 256)]


def _pair(a, dt):
    """The same values in both packages (bf16 rounded once, by JAX)."""
    jdt, tdt = DTYPES[dt]
    ja = jnp.asarray(a).astype(jdt)
    return ja, torch.from_numpy(np.array(ja.astype(jnp.float64))).to(tdt)


def _same(j, t):
    """Bit-for-bit: same dtype width, same values (NaN-free here)."""
    jn = np.asarray(j.astype(jnp.float64) if j.dtype == jnp.bfloat16 else j)
    tn = t.double().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    assert jn.dtype == tn.dtype or (j.dtype == jnp.bfloat16
                                    and t.dtype == torch.bfloat16)
    np.testing.assert_array_equal(tn, jn)


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_and_halo_bit_for_bit(dt, shape):
    ja, ta = _pair(_draw(shape, 0), dt)
    je, te = _pair(_draw(shape, 1) * 1e-3, dt)
    for axis in (None, -1):
        (q1, s1), (q2, s2) = J.quantize_int8(ja, axis), T.quantize_int8(
            ta, axis)
        assert q2.dtype == torch.int8 and s2.dtype == torch.float32
        _same(q1, q2)
        _same(s1, s2)
        _same(J.dequantize_int8(q1, s1), T.dequantize_int8(q2, s2))
    for ef_j, ef_t in ((None, None), (je, te)):
        q1, s1, f1 = J.compress_halo(ja, ef_j)
        q2, s2, f2 = T.compress_halo(ta, ef_t)
        assert f2.dtype == ta.dtype
        _same(q1, q2)
        _same(s1, s2)
        _same(f1, f2)
        _same(J.decompress_halo(q1, s1), T.decompress_halo(q2, s2))
        _same(J.decompress_halo(q1, s1, ja.dtype),
              T.decompress_halo(q2, s2, ta.dtype))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", [(3, 6), (7, 6)])
def test_compress_gram_bit_for_bit(dt, shape):
    ja, ta = _pair(_draw(shape, 2), dt)
    je, te = _pair(_draw(shape, 3) * 1e-3, dt)
    keep = np.zeros(shape, bool)
    keep[(6, 0) if shape == (7, 6) else (slice(None), 5)] = True
    for pj, pt in ((None, None), (jnp.asarray(keep), torch.from_numpy(keep))):
        for ef_j, ef_t in ((None, None), (je, te)):
            o1, g1 = J.compress_gram(ja, ef_j, preserve=pj)
            o2, g2 = T.compress_gram(ta, ef_t, preserve=pt)
            _same(o1, o2)
            _same(g1, g2)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_trees_bit_for_bit(dt):
    leaves = [_draw((4, 5), 4), _draw((7,), 5), _draw((2, 3), 6)]
    jl, tl = zip(*(_pair(a, dt) for a in leaves))
    jtree = {"w": jl[0], "blocks": [jl[1], {"b": jl[2]}]}
    ttree = {"w": tl[0], "blocks": [tl[1], {"b": tl[2]}]}
    q1, s1, e1 = J.compress_tree(jtree)
    q2, s2, e2 = T.compress_tree(ttree)
    for a, b in ((q1, q2), (s1, s2), (e1, e2)):
        _same(a["w"], b["w"])
        _same(a["blocks"][0], b["blocks"][0])
        _same(a["blocks"][1]["b"], b["blocks"][1]["b"])
    d1, d2 = J.decompress_tree(q1, s1), T.decompress_tree(q2, s2)
    _same(d1["blocks"][1]["b"], d2["blocks"][1]["b"])
    g1, f1 = J.compressed_grads(jtree, e1)
    g2, f2 = T.compressed_grads(ttree, e2)
    for a, b in ((g1, g2), (f1, f2)):
        _same(a["w"], b["w"])
        _same(a["blocks"][0], b["blocks"][0])
        _same(a["blocks"][1]["b"], b["blocks"][1]["b"])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_quantize_int8_scale_floor(dt):
    tdt = DTYPES[dt][1]
    q, scale = T.quantize_int8(torch.zeros(4, dtype=tdt))
    assert float(scale) > 0.0                     # no divide-by-zero scale
    qj, sj = J.quantize_int8(jnp.zeros(4, DTYPES[dt][0]))
    assert float(scale) == float(sj)              # 1e-12 / 127, rounded
    np.testing.assert_array_equal(T.dequantize_int8(q, scale).numpy(),
                                  np.zeros(4))


def test_compress_halo_roundtrip_and_error_feedback():
    strip = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 16)))
    q, scale, ef = T.compress_halo(strip)
    assert q.dtype == torch.int8
    recon = T.decompress_halo(q, scale, strip.dtype)
    # max-abs scaling: the rounding error is at most half a grid step
    assert float(torch.max(torch.abs(strip - recon))) \
        <= float(scale) / 2 + 1e-12
    # with no feedback in, the returned feedback IS the rounding residual
    np.testing.assert_allclose(ef.numpy(), (strip - recon).numpy(), rtol=0,
                               atol=1e-12)
    # second send: the corrected payload is strip + ef, and the new
    # feedback closes the telescoping sum (corrected - recon2)
    q2, scale2, ef2 = T.compress_halo(strip, error_feedback=ef)
    recon2 = T.decompress_halo(q2, scale2, strip.dtype)
    np.testing.assert_allclose(ef2.numpy(), (strip + ef - recon2).numpy(),
                               rtol=0, atol=1e-12)
    # summed over sends, what arrived differs from what was sent by the
    # last feedback only (the telescoping sum)
    sent, got, e = torch.zeros_like(strip), torch.zeros_like(strip), None
    for k in range(20):
        s = strip * (1 + 0.1 * k)
        qk, sk, e = T.compress_halo(s, e)
        sent, got = sent + s, got + T.decompress_halo(qk, sk, s.dtype)
    np.testing.assert_allclose((sent - got).numpy(), e.numpy(), rtol=0,
                               atol=1e-12)


def test_compress_gram_per_row_scales_and_preserve_mask():
    partial = torch.tensor([[1e-6, 2e-6, -1.5e-6, 3e-6, 0.5e-6, 1e-6],
                            [1e+2, -2e+2, 1.5e+2, 3e+2, 0.5e+2, 1e+2]],
                           dtype=torch.float64)
    out, ef = T.compress_gram(partial)
    rel = (torch.abs(out - partial)
           / torch.amax(torch.abs(partial), dim=-1, keepdim=True))
    # half a grid step per row (scales are fp32, hence the slack)
    assert float(rel.max()) <= 0.5 / 127 * (1 + 1e-5)
    assert float(torch.min(torch.abs(out[0]))) > 0.0   # not flushed
    preserve = torch.zeros(partial.shape, dtype=torch.bool)
    preserve[:, -1] = True
    out_p, ef_p = T.compress_gram(partial, preserve=preserve)
    assert torch.equal(out_p[:, -1], partial[:, -1])
    assert float(torch.max(torch.abs(ef_p[:, -1]))) == 0.0


class _Count(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_compress_tree_quantizes_each_leaf_exactly_once():
    tree = {"a": torch.arange(8.0), "b": [torch.ones(3), torch.zeros(2)]}
    with _Count() as count:
        T.compress_tree(tree)
    assert count.calls.get("round") == 3
    assert count.calls.get("amax") == 3
    with _Count() as count:
        T.compressed_grads({"a": torch.arange(8.0)})
    assert count.calls.get("round") == 1 and count.calls.get("amax") == 1
