"""The port's BSR operator, its kernels' plain versions and the BSR solves
against the JAX package.

The operators are the three BSR fixtures of tests/test_operator.py (the
1-D Laplacian at bs 4, a 7-band glen operator at bs 8, a random 3-band
operator at bs 2) and ``laplacian_2d(8, 6)`` at bs 4, built in the JAX
package and carried across as numpy arrays.  ``dia_to_bsr``'s arrays and
``fingerprint()`` must be byte-identical; matvec, the column checksum and
the kernels' plain versions sum in another order than the reference's
einsum and scatter, so they are held to 1e-13 of the largest entry
(vectors) and the reduction partials to 1e-12 of their terms' magnitude.

The reference's BSR kernels are Pallas kernels that do not run under this
JAX (ROADMAP.md queue 3, H1): the plain versions are held against
``kernels/ref.py`` and the port's fused solves against the JAX package's
``engine="naive"``, residual histories to rtol 1e-10 above a 1e-10
relative floor over at most 80 iterations (H6), ``iters`` exactly.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.krylov as jk
from repro.core.krylov.hostops import true_residual_norm as j_true_res
from repro.core.krylov.operator import dia_to_bsr as j_dia_to_bsr
from repro.kernels import ref
from repro.kernels.checksum import bsr_column_checksum as j_bsr_checksum
from repro_torch import convert
from repro_torch.core.krylov import (BsrMatrix, SolverOptions, SparseOperator,
                                     dia_to_bsr, pipecg, pipecg_multi, pipecr,
                                     true_residual_norm)
from repro_torch.kernels import ops
from repro_torch.kernels.checksum import bsr_column_checksum
from repro_torch.kernels.spmv_bsr import (pipecg_bsr_fused,
                                          pipecg_bsr_fused_plain, spmv_bsr,
                                          spmv_bsr_plain)


def _rand_dia():
    rng = np.random.default_rng(0)
    return jk.DiaMatrix(offsets=(-2, 0, 1), bands=jnp.asarray(np.stack([
        np.concatenate([[0.0, 0.0], rng.standard_normal(46)]),
        rng.standard_normal(48) + 8.0,
        np.concatenate([rng.standard_normal(47), [0.0]])])))


def _spd_tridiag(n, seed):
    """Symmetric tridiagonal SPD with a varying diagonal (Jacobi matters)."""
    rng = np.random.default_rng(seed)
    off = -rng.uniform(0.5, 1.0, n)
    lo = np.concatenate([[0.0], off[:-1]])
    hi = np.concatenate([off[:-1], [0.0]])
    main = np.abs(lo) + np.abs(hi) + rng.uniform(1e-3, 2e-2, n)
    return jk.DiaMatrix(offsets=(-1, 0, 1),
                        bands=jnp.asarray(np.stack([lo, main, hi])))


# name: (JAX DIA operator factory, block size)
DIA = {
    "tri": (lambda: jk.tridiagonal_laplacian(96), 4),
    "band": (lambda: jk.glen_law_band(64, bandwidth=3, seed=1), 8),
    "rand": (_rand_dia, 2),
    "lap2d": (lambda: jk.laplacian_2d(8, 6), 4),
}
FIXTURES = ["tri", "band", "rand"]   # tests/test_operator.py's BSR three


def _jax_bsr(name):
    A, bs = DIA[name]
    return j_dia_to_bsr(A(), bs=bs)


def _port_bsr(J):
    return convert.bsr_from_numpy(np.asarray(J.indices),
                                  np.asarray(J.blocks), device="cpu")


def _close(got, want, rtol=1e-13):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1.0))


# -- the operator --------------------------------------------------------------

@pytest.mark.parametrize("name", list(DIA))
def test_dia_to_bsr_is_byte_identical(name):
    A, bs = DIA[name]
    J = j_dia_to_bsr(A(), bs=bs)
    A = A()
    T = dia_to_bsr(convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                          device="cpu"), bs=bs)
    assert T.indices.dtype == torch.int32
    np.testing.assert_array_equal(T.indices.numpy(), np.asarray(J.indices))
    assert T.blocks.numpy().tobytes() == np.asarray(J.blocks).tobytes()
    assert T.blocks.dtype == torch.float64
    assert T.fingerprint() == J.fingerprint()


def test_dia_to_bsr_rejects_an_uneven_block_size():
    T = convert.dia_from_numpy((-1, 0, 1), np.ones((3, 10)), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        dia_to_bsr(T, bs=4)
    with pytest.raises(ValueError, match="not divisible"):
        j_dia_to_bsr(jk.tridiagonal_laplacian(10), bs=4)


def test_dia_to_bsr_pads_with_self_pointing_zero_blocks():
    """Block row 0 of the 1-D Laplacian stores 2 blocks of 3: its pad
    points at itself and is zero; an all-zero operator gets degree 1."""
    T = dia_to_bsr(convert.dia_from_numpy(
        (-1, 0, 1), np.asarray(jk.tridiagonal_laplacian(16).bands),
        device="cpu"), bs=4)
    assert T.indices[0].tolist() == [0, 1, 0]
    assert bool((T.blocks[0, 2] == 0).all())
    Z = dia_to_bsr(convert.dia_from_numpy((0,), np.zeros((1, 8)),
                                          device="cpu"), bs=4)
    assert Z.max_deg == 1 and Z.indices[:, 0].tolist() == [0, 1]


@pytest.mark.parametrize("name", FIXTURES)
def test_protocol_members_match_reference(name):
    J = _jax_bsr(name)
    T = _port_bsr(J)
    assert isinstance(T, SparseOperator)
    for attr in ("n", "n_block_rows", "bs", "max_deg", "format", "halo",
                 "block_halo"):
        assert getattr(T, attr) == getattr(J, attr), attr
    assert str(T.dtype) == "torch." + str(J.dtype)
    th, jh = T.halo_spec(), J.halo_spec()
    assert (th.ndim, th.neighbors, th.widths) == (jh.ndim, jh.neighbors,
                                                  jh.widths)
    assert T.words_per_iter() == J.words_per_iter()
    assert T.fingerprint() == J.fingerprint()
    assert T.structure_key() == J.structure_key()
    assert T.inf_norm() == J.inf_norm()


@pytest.mark.parametrize("name", FIXTURES)
def test_matvec_diagonal_dense_match_reference(name):
    J = _jax_bsr(name)
    T = _port_bsr(J)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(T.n)
    X = rng.standard_normal((3, T.n))
    _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))
    _close(T.matvec(torch.from_numpy(X)), J.matvec(jnp.asarray(X)))
    np.testing.assert_array_equal(T.diagonal().numpy(),
                                  np.asarray(J.diagonal()))
    np.testing.assert_array_equal(T.to_dense().numpy(),
                                  np.asarray(J.to_dense()))
    _close(T.host_matvec(X), J.host_matvec(X))
    _close(T.column_checksum(), J.column_checksum())
    _close(bsr_column_checksum(T.indices, T.blocks),
           j_bsr_checksum(J.indices, J.blocks))


@pytest.mark.parametrize("name", FIXTURES + ["lap2d"])
def test_block_bands_rebuild_the_dense_matrix(name):
    J = _jax_bsr(name)
    T = _port_bsr(J)
    boffs, bb = T.block_bands()
    jboffs, jbb = J.block_bands()
    assert boffs == jboffs
    np.testing.assert_array_equal(bb.numpy(), np.asarray(jbb))
    nbr, bs = T.n_block_rows, T.bs
    dense = torch.zeros((nbr, bs, nbr, bs), dtype=bb.dtype)
    for m, off in enumerate(boffs):
        for i in range(max(0, -off), min(nbr, nbr - off)):
            dense[i, :, i + off, :] += bb[m, i]
    np.testing.assert_array_equal(dense.reshape(T.n, T.n).numpy(),
                                  T.to_dense().numpy())


def test_bsr_matrix_checks_its_arrays():
    ind = torch.zeros((4, 2), dtype=torch.int32)
    blk = torch.zeros((4, 2, 3, 3), dtype=torch.float64)
    BsrMatrix(indices=ind, blocks=blk)
    with pytest.raises(ValueError, match="int32"):
        BsrMatrix(indices=ind.long(), blocks=blk)
    with pytest.raises(ValueError, match="do not fit"):
        BsrMatrix(indices=ind, blocks=blk[:, :1])
    with pytest.raises(ValueError, match="outside"):
        BsrMatrix(indices=ind + 4, blocks=blk)


@pytest.mark.parametrize("fmt", ["dia", "bsr"])
def test_true_residual_norm_matches_reference(fmt):
    A = jk.laplacian_2d(8, 6)
    rng = np.random.default_rng(2)
    b, x = rng.standard_normal(A.n), rng.standard_normal(A.n)
    if fmt == "dia":
        J = A
        T = convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                   device="cpu")
    else:
        J = j_dia_to_bsr(A, bs=4)
        T = _port_bsr(J)
    want = j_true_res(J, b, x)
    assert true_residual_norm(T, b, torch.from_numpy(x)) == \
        pytest.approx(want, rel=1e-13)


# -- the kernels' plain versions -----------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", FIXTURES)
def test_spmv_bsr_plain_matches_ref(name, k):
    J = _jax_bsr(name)
    T = _port_bsr(J)
    x = np.random.default_rng(3).standard_normal((k, T.n))
    want = ref.spmv_bsr_ref(J.indices, J.blocks, jnp.asarray(x))
    _close(spmv_bsr_plain(T.indices, T.blocks, torch.from_numpy(x)), want)
    # the wrapper takes the plain version on CPU tensors, unbatched too
    _close(ops.spmv_bsr_step(T.indices, T.blocks, torch.from_numpy(x[0])),
           np.asarray(want)[0])


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("name", FIXTURES)
def test_pipecg_bsr_fused_plain_matches_ref(name, jacobi):
    J = _jax_bsr(name)
    T = _port_bsr(J)
    k, n = 3, T.n
    rng = np.random.default_rng(4)
    x, r, u, p = (rng.standard_normal((k, n)) for _ in range(4))
    alpha, beta = rng.uniform(0.1, 1.0, k), rng.uniform(0.1, 1.0, k)
    invd = (1.0 / np.asarray(J.diagonal())) if jacobi else np.ones(n)
    want = ref.pipecg_bsr_fused_ref(J.indices, J.blocks, jnp.asarray(invd),
                                    *map(jnp.asarray, (x, r, u, p, alpha,
                                                       beta)))
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    got = pipecg_bsr_fused_plain(T.indices, T.blocks, t(invd),
                                 T.column_checksum(), t(x), t(r), t(u), t(p),
                                 t(alpha), t(beta))
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)
    # partials: held to their terms' magnitude (another summation order)
    x2, r2, u2, p2 = (np.asarray(v) for v in want[:4])
    w2 = np.asarray(ref.spmv_bsr_ref(J.indices, J.blocks, jnp.asarray(u2)))
    c = np.asarray(J.column_checksum())
    mags = np.stack([np.abs(a).sum(-1) for a in
                     (r2 * u2, w2 * u2, r2 * r2, r2 * w2, w2 * w2)]
                    + [np.abs(w2).sum(-1) + np.abs(c * u2).sum(-1)], -1)
    rel = np.abs(got[4].numpy() - np.asarray(want[4])) / mags
    assert rel.max() <= 1e-12
    # the CPU wrapper and the single-RHS step are the plain version
    again = pipecg_bsr_fused(T.indices, T.blocks, t(invd),
                             T.column_checksum(), t(x), t(r), t(u), t(p),
                             t(alpha), t(beta))
    for g, w in zip(again, got):
        assert torch.equal(g, w)
    one = ops.pipecg_bsr_fused_step(T.indices, T.blocks, t(invd),
                                    T.column_checksum(), t(x[0]), t(r[0]),
                                    t(u[0]), t(p[0]), t(alpha[0]),
                                    t(beta[0]))
    assert tuple(one[0].shape) == (n,) and tuple(one[4].shape) == (6,)
    for g, w in zip(one, got):
        np.testing.assert_allclose(g.numpy(), w[0].numpy(), rtol=0,
                                   atol=1e-13 * max(w.abs().max(), 1.0))


def test_bsr_wrappers_reject_devices_without_a_kernel():
    T = _port_bsr(_jax_bsr("tri"))
    x = torch.zeros(T.n, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spmv_bsr(T.indices, T.blocks, x)
    with pytest.raises(ValueError, match="operands on"):
        spmv_bsr(T.indices.to("meta"), T.blocks, torch.zeros(T.n))


# -- the solves ----------------------------------------------------------------

def _hist_close(want, got, rtol=1e-10, floor_rel=1e-10):
    hw = np.asarray(want)
    hg = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert hw.shape == hg.shape
    mask = hw > floor_rel * max(hw.max(), 1.0)
    assert mask.sum() > 0
    np.testing.assert_allclose(hg[mask], hw[mask], rtol=rtol)


SOLVE_OPS = {
    "ex23": (lambda: jk.tridiagonal_laplacian(512), 4, 0),
    "spd": (lambda: _spd_tridiag(512, seed=3), 4, 1),
    "lap2d": (lambda: jk.laplacian_2d(16, 16), 4, 2),
    "glen": (lambda: jk.glen_law_band(256, bandwidth=8), 8, 3),
}
# name: (solver, operator, options); histories over the iterations H6 allows
SOLVES = {
    "pipecg": ("pipecg", "ex23", dict(maxiter=80)),
    "pipecr": ("pipecr", "ex23", dict(maxiter=80)),
    "pipecg-jacobi": ("pipecg", "spd", dict(maxiter=60, M="jacobi")),
    "pipecg-lap2d": ("pipecg", "lap2d", dict(maxiter=20)),
    "pipecg-glen": ("pipecg", "glen", dict(maxiter=12, M="jacobi")),
    "pipecg-tol": ("pipecg", "spd", dict(maxiter=80, tol=3e-2)),
    "pipecg-callable-M": ("pipecg", "ex23", dict(maxiter=60, M="half")),
    "pipecg-inline": ("pipecg", "ex23", dict(maxiter=80, engine=None)),
}


def _solve_operands(op):
    factory, bs, seed = SOLVE_OPS[op]
    J = j_dia_to_bsr(factory(), bs=bs)
    b = np.random.default_rng(seed).standard_normal(J.n)
    return J, _port_bsr(J), b


@pytest.mark.parametrize("name", list(SOLVES))
def test_bsr_solves_match_reference_naive(name):
    solver, op, kw = SOLVES[name]
    kw = dict(kw)
    J, T, b = _solve_operands(op)
    engine = kw.pop("engine", "fused")
    if kw.get("M") == "half":
        kw["M"] = lambda z: 0.5 * z
    want = getattr(jk, solver)(J, jnp.asarray(b), options=jk.SolverOptions(
        engine="naive" if engine else None, **kw))
    ops.reset_launch_counts()
    got = {"pipecg": pipecg, "pipecr": pipecr}[solver](
        T, torch.from_numpy(b.copy()),
        options=SolverOptions(engine=engine, **kw))
    assert sum(ops.launch_counts().values()) == 0   # plain versions here
    _hist_close(want.res_history, got.res_history)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    if kw.get("tol"):
        assert int(got.iters) < kw["maxiter"]
    xw = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), xw, rtol=0,
                               atol=1e-10 * np.abs(xw).max())
    if engine == "fused" and name != "pipecg-callable-M":
        # the ABFT checksum column rode the BSR sweep at rounding level
        assert float(got.detect_history.abs().max()) < 1e-9


def test_bsr_sweep_equals_the_dia_sweep_on_the_same_operator():
    """The fused solve on dia_to_bsr(A) follows the DIA sweep on A."""
    A = jk.tridiagonal_laplacian(512)
    D = convert.dia_from_numpy(A.offsets, np.asarray(A.bands), device="cpu")
    T = dia_to_bsr(D, bs=4)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(512))
    for M in (None, "jacobi"):
        opts = SolverOptions(engine="fused", maxiter=80, M=M)
        _hist_close(pipecg(D, b, options=opts).res_history,
                    pipecg(T, b, options=opts).res_history)


def test_bsr_pipecg_multi_matches_reference_and_single_solves():
    J, T, _ = _solve_operands("ex23")
    B = np.random.default_rng(5).standard_normal((3, T.n))
    want = jk.pipecg_multi(J, jnp.asarray(B), maxiter=60, engine="naive")
    got = pipecg_multi(T, torch.from_numpy(B), maxiter=60, engine="fused")
    assert tuple(got.res_history.shape) == (3, 60)
    _hist_close(want.res_history, got.res_history)
    for j in range(3):
        one = pipecg(T, torch.from_numpy(B[j].copy()),
                     options=SolverOptions(engine="fused", maxiter=60))
        _hist_close(one.res_history, got.res_history[j], rtol=1e-13)


def test_storage_precision_on_bsr_raises_as_reference():
    J, T, b = _solve_operands("ex23")
    with pytest.raises(ValueError, match="DIA band stream"):
        jk.pipecg(J, jnp.asarray(b), options=jk.SolverOptions(
            engine="naive", maxiter=3, precision="bf16"))
    with pytest.raises(ValueError, match="DIA band stream"):
        pipecg(T, torch.from_numpy(b), options=SolverOptions(
            engine="fused", maxiter=3, precision="bf16"))
