"""The port's kernel modules against the JAX reference oracles.

On the CPU each wrapper takes its plain torch version, which is held
against ``repro/kernels/ref.py`` on the same numpy inputs (float64, rtol
and atol 1e-12; the halo sweeps' rank slices 1e-13 against the global
sweep, and their partial rows and Gram payloads to 1e-12 of their terms'
magnitudes), and
``fused_dots`` against the JAX package's Pallas kernel run in interpret
mode.  The ghost-chain sweep's plain version multiplies by 1/theta where
the reference's naive chain divides by theta: chains to rtol 1e-14 of
their largest entry (1e-6 in float32), Grams to 1e-12 (1e-5) of their
terms' magnitudes; its rank slices equal the one-device chain bit for
bit.  tests/test_torch_cuda.py holds the CUDA kernels against
the plain versions on the card.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.krylov import operators as jops
from repro.kernels import ref
from repro.kernels.checksum import dia_column_checksum as j_checksum
from repro_torch import convert
from repro_torch.core.krylov.engine import get_engine
from repro_torch.kernels import build, ops
from repro_torch.kernels.checksum import dia_column_checksum
from repro_torch.kernels.pipebicgstab_fused import (
    pipebicgstab_fused, pipebicgstab_fused_plain, pipebicgstab_halo_plain)
from repro_torch.kernels.pipecg_spmv_fused import (SWEEP_SMEM_LIMIT,
                                                   chain_plan,
                                                   ghost_chain_fused,
                                                   ghost_chain_fused_plain,
                                                   ghost_chain_halo,
                                                   ghost_chain_halo_plain,
                                                   pipecg_spmv_fused_plain,
                                                   pipecg_spmv_halo_plain)
from repro_torch.kernels.spmv_dia import spmv_dia, spmv_dia_plain

TOL = dict(rtol=1e-12, atol=1e-12)


def _ops():
    return {"tridiag": jops.tridiagonal_laplacian(257),
            "lap2d": jops.laplacian_2d(16, 11),
            "convdiff": jops.convection_diffusion(130)}


@pytest.fixture(scope="module", params=["tridiag", "lap2d", "convdiff"])
def op(request):
    A = _ops()[request.param]
    return A, convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                     device="cpu")


def _state(n, k, seed):
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal((k, n)) for _ in range(4)]
    return vecs, rng.uniform(0.1, 1.0, k), rng.uniform(0.0, 0.9, k)


def test_spmv_plain_matches_ref(op):
    A, T = op
    x = np.random.default_rng(1).standard_normal(A.n)
    h = A.halo
    want = ref.spmv_dia_ref(A.offsets, A.bands, jnp.pad(jnp.asarray(x),
                                                         (h, h)), h)
    got = spmv_dia_plain(T.offsets, T.bands, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spmv_wrapper_batched_on_cpu(op):
    _, T = op
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((3, T.n)))
    before = spmv_dia.launches
    got = spmv_dia(T.offsets, T.bands, X)
    assert spmv_dia.launches == before  # the CPU never launches a kernel
    for j in range(3):
        assert torch.equal(got[j], spmv_dia_plain(T.offsets, T.bands, X[j]))
    assert torch.equal(got, T.matvec(X))


@pytest.mark.parametrize("jacobi", [False, True])
def test_pipecg_spmv_fused_plain_matches_ref(op, jacobi):
    A, T = op
    k = 3
    (x, r, u, p), alpha, beta = _state(A.n, k, seed=4)
    diag = np.asarray(A.diagonal())
    invd = 1.0 / diag if jacobi else np.ones(A.n)
    want = ref.pipecg_spmv_fused_ref(
        A.offsets, A.bands, jnp.asarray(invd), *(jnp.asarray(v) for v in
                                                 (x, r, u, p)),
        jnp.asarray(alpha), jnp.asarray(beta))
    t = torch.from_numpy
    got = pipecg_spmv_fused_plain(
        T.offsets, T.bands, t(invd), T.column_checksum(),
        *(t(v) for v in (x, r, u, p)), t(alpha), t(beta))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_pipecg_spmv_fused_step_single_rhs(op):
    A, T = op
    (x, r, u, p), alpha, beta = _state(A.n, 1, seed=5)
    t = torch.from_numpy
    one = torch.ones(A.n, dtype=torch.float64)
    csum = T.column_checksum()
    batched = ops.pipecg_spmv_fused_step(
        T.offsets, T.bands, one, csum, *(t(v) for v in (x, r, u, p)),
        t(alpha), t(beta))
    single = ops.pipecg_spmv_fused_step(
        T.offsets, T.bands, one, csum, *(t(v[0]) for v in (x, r, u, p)),
        torch.tensor(alpha[0]), torch.tensor(beta[0]))
    for b, s in zip(batched, single):
        assert torch.equal(b[0], s)
    assert ops.launch_counts()["pipecg_spmv_fused"] == 0


def test_pipecg_fused_plain_matches_ref():
    n = 300
    rng = np.random.default_rng(6)
    vecs = [rng.standard_normal(n) for _ in range(10)]
    alpha, beta = 0.7, 0.3
    want = ref.pipecg_fused_ref(*(jnp.asarray(v) for v in vecs), alpha, beta)
    got = ops.pipecg_fused_step(*(torch.from_numpy(v) for v in vecs),
                                torch.tensor(alpha, dtype=torch.float64),
                                torch.tensor(beta, dtype=torch.float64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert ops.launch_counts()["pipecg_fused"] == 0


def test_bf16_storage_sweep_narrows_only_the_stores():
    """bf16 storage: loads widen, arithmetic at float64, r'/u'/p' narrow."""
    A = jops.tridiagonal_laplacian(200)
    T = convert.dia_from_numpy(A.offsets, np.asarray(A.bands), device="cpu")
    (x, r, u, p), alpha, beta = _state(A.n, 2, seed=7)
    bf = torch.bfloat16
    t = torch.from_numpy
    r_b, u_b, p_b = (t(v).to(bf) for v in (r, u, p))
    bands_b = T.bands.to(bf)
    invd_b = torch.ones(A.n, dtype=bf)
    got = pipecg_spmv_fused_plain(
        T.offsets, bands_b, invd_b, dia_column_checksum(T.offsets, bands_b),
        t(x), r_b, u_b, p_b, t(alpha), t(beta))
    # the reference oracle on the widened inputs, at float64
    wide = [np.asarray(v.to(torch.float64)) for v in (r_b, u_b, p_b)]
    want = ref.pipecg_spmv_fused_ref(
        A.offsets, jnp.asarray(bands_b.to(torch.float64).numpy()),
        jnp.ones(A.n), jnp.asarray(x), *(jnp.asarray(v) for v in wide),
        jnp.asarray(alpha), jnp.asarray(beta))
    assert got[0].dtype == torch.float64 and got[4].dtype == torch.float64
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), **TOL)
    for g, w in zip(got[1:4], want[1:4]):
        assert g.dtype == bf
        # one bf16 rounding of the float64 value
        np.testing.assert_array_equal(
            g.to(torch.float64).numpy(),
            torch.from_numpy(np.array(w)).to(bf).to(torch.float64).numpy())


def test_wrappers_reject_devices_without_a_kernel():
    T = convert.dia_from_numpy((-1, 0, 1), np.ones((3, 8)), device="cpu")
    x = torch.zeros(8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spmv_dia(T.offsets, T.bands, x)


def test_checksum_matches_reference():
    A = jops.convection_diffusion(50)
    got = dia_column_checksum(A.offsets, torch.from_numpy(np.array(A.bands)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_checksum(A.offsets, A.bands)))


def test_build_is_lazy_and_names_sm90a():
    """Importing the kernels builds nothing; the flags target sm_90a."""
    assert build._lib is None or torch.cuda.is_available()
    assert "arch=compute_90a,code=sm_90a" in build.ARCH
    assert build.library_path().parent == build.BUILD_DIR
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == [
        "flash_attn.cu", "fused_dots.cu", "ghost_chain.cu",
        "pipebicgstab_fused.cu", "pipecg_fused.cu", "pipecg_spmv_fused.cu",
        "spmv_bsr.cu", "spmv_dia.cu", "wkv.cu"]


# -- the per-rank halo sweep --------------------------------------------------

def _rank_operands(A, P, q, vecs, invd):
    """Rank q's operands cut from the global arrays, with real strips.

    The operator rows [lo - h, hi + h) and the u/p rows [lo - 2h, lo) and
    [hi, hi + 2h), zero beyond the matrix, as the halo exchange gives them.
    """
    h, n = A.halo, A.n
    lo, hi = q * n // P, (q + 1) * n // P
    bands = np.pad(np.asarray(A.bands), ((0, 0), (h, h)))[:, lo:hi + 2 * h]
    invd_e = np.pad(invd, (h, h))[lo:hi + 2 * h]
    x, r, u, p = vecs
    wide = [np.pad(v, ((0, 0), (2 * h, 2 * h))) for v in (u, p)]
    strips = []
    for v in wide:
        strips += [v[:, lo:lo + 2 * h], v[:, hi + 2 * h:hi + 4 * h]]
    t = torch.from_numpy
    bands_t = t(np.ascontiguousarray(bands))
    csum = dia_column_checksum(A.offsets, bands_t, halo=h)
    local = [t(np.ascontiguousarray(v[:, lo:hi])) for v in (x, r, u, p)]
    u_lo, u_hi, p_lo, p_hi = (t(np.ascontiguousarray(s)) for s in strips)
    return (bands_t, t(np.ascontiguousarray(invd_e)), csum, *local,
            u_lo, u_hi, p_lo, p_hi), slice(lo, hi)


def _halo_case(A, k, jacobi, seed):
    (x, r, u, p), alpha, beta = _state(A.n, k, seed=seed)
    invd = (1.0 / np.asarray(A.diagonal()) if jacobi else np.ones(A.n))
    want = ref.pipecg_spmv_fused_ref(
        A.offsets, A.bands, jnp.asarray(invd),
        *(jnp.asarray(v) for v in (x, r, u, p)), jnp.asarray(alpha),
        jnp.asarray(beta))
    return (x, r, u, p), alpha, beta, invd, [np.asarray(w) for w in want]


def _red_mags(A, want):
    """Sum of each reduction entry's terms' magnitudes (its rounding scale)."""
    _, r2, u2, _, _ = want
    w2 = np.asarray(A.matvec(jnp.asarray(u2)))
    c = np.asarray(j_checksum(A.offsets, A.bands))
    terms = [r2 * u2, w2 * u2, r2 * r2, r2 * w2, w2 * w2]
    return np.stack([np.abs(t).sum(-1) for t in terms]
                    + [np.abs(w2).sum(-1) + np.abs(c * u2).sum(-1)], -1)


def _random_banded(n, offsets, seed):
    """A banded operator with every entry random (zero outside the matrix),
    so an operator row read from the wrong place changes the sweep."""
    rng = np.random.default_rng(seed)
    bands = rng.uniform(-1.0, 1.0, (len(offsets), n))
    bands[list(offsets).index(0)] = rng.uniform(2.0, 3.0, n)
    i = np.arange(n)
    for kb, off in enumerate(offsets):
        bands[kb][(i + off < 0) | (i + off >= n)] = 0.0
    return jops.DiaMatrix(offsets=tuple(offsets), bands=jnp.asarray(bands))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", ["tridiag", "lap2d", "random"])
def test_pipecg_spmv_halo_plain_slices_match_ref(name, P, k):
    """P ranks' sweeps on slices of one global state equal the reference
    sweep on the global arrays row for row, and their partial rows sum to
    its reduction row."""
    A = {"tridiag": jops.tridiagonal_laplacian(256),
         "lap2d": jops.laplacian_2d(16, 16),
         "random": _random_banded(256, (-3, -1, 0, 2), seed=11)}[name]
    vecs, alpha, beta, invd, want = _halo_case(A, k, jacobi=True, seed=12)
    total = np.zeros((k, 6))
    for q in range(P):
        args, rows = _rank_operands(A, P, q, vecs, invd)
        got = pipecg_spmv_halo_plain(A.offsets, *args, torch.from_numpy(alpha),
                                     torch.from_numpy(beta))
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_allclose(g.numpy(), w[:, rows], rtol=1e-13,
                                       atol=1e-13 * np.abs(w).max())
        total += got[4].numpy()
    assert np.all(np.abs(total - want[4]) <= 1e-12 * _red_mags(A, want))


def test_pipecg_spmv_halo_reads_the_neighbour_rows():
    """Rank 1 of 4 needs its neighbours' operator rows and strips: read
    as zero, or swapped, they change its rows or the summed partials."""
    A = _random_banded(256, (-3, -1, 0, 2), seed=13)
    vecs, alpha, beta, invd, want = _halo_case(A, 2, jacobi=True, seed=14)
    a, b = torch.from_numpy(alpha), torch.from_numpy(beta)
    h = A.halo
    ranks = [_rank_operands(A, 4, q, vecs, invd) for q in range(4)]

    def agrees(args1):
        total = np.zeros((2, 6))
        same = True
        for q, (args, rows) in enumerate(ranks):
            got = pipecg_spmv_halo_plain(A.offsets, *(args1 if q == 1
                                                      else args), a, b)
            same &= all(np.allclose(g.numpy(), w[:, rows], rtol=1e-12,
                                    atol=1e-12)
                        for g, w in zip(got[:4], want[:4]))
            total += got[4].numpy()
        return same and bool(np.all(np.abs(total - want[4])
                                    <= 1e-12 * _red_mags(A, want)))

    args = ranks[1][0]
    assert agrees(args)
    bands, invd_e = args[0].clone(), args[1].clone()
    bands[:, :h] = 0
    bands[:, -h:] = 0
    invd_e[:h] = 0
    invd_e[-h:] = 0
    u_lo, u_hi, p_lo, p_hi = args[7:]
    for bad in ((bands,) + args[1:], args[:1] + (invd_e,) + args[2:],
                args[:7] + (u_hi, u_lo, p_lo, p_hi),
                args[:7] + (u_lo, u_hi, p_hi, p_lo)):
        assert not agrees(bad)


def test_pipecg_spmv_halo_step_single_rhs():
    A = _random_banded(96, (-1, 0, 1), seed=15)
    vecs, alpha, beta, invd, _ = _halo_case(A, 1, jacobi=False, seed=16)
    args, _ = _rank_operands(A, 2, 0, vecs, invd)
    a, b = torch.from_numpy(alpha), torch.from_numpy(beta)
    batched = ops.pipecg_spmv_halo_step(A.offsets, *args, a, b)
    single = ops.pipecg_spmv_halo_step(
        A.offsets, *args[:3], *(v[0] for v in args[3:]),
        torch.tensor(alpha[0]), torch.tensor(beta[0]))
    for bt, s in zip(batched, single):
        assert torch.equal(bt[0], s)
    assert ops.launch_counts()["pipecg_spmv_halo"] == 0


def test_halo_sweep_with_no_neighbours_is_the_sweep(op):
    """One rank (zero strips and extension) is the single-device sweep."""
    A, T = op
    (x, r, u, p), alpha, beta = _state(A.n, 2, seed=17)
    t = torch.from_numpy
    h = A.halo
    invd = torch.ones(A.n, dtype=torch.float64)
    csum = T.column_checksum()
    want = pipecg_spmv_fused_plain(T.offsets, T.bands, invd, csum,
                                   *(t(v) for v in (x, r, u, p)),
                                   t(alpha), t(beta))
    z = torch.zeros((2, 2 * h), dtype=torch.float64)
    got = pipecg_spmv_halo_plain(
        T.offsets, torch.nn.functional.pad(T.bands, (h, h)),
        torch.nn.functional.pad(invd, (h, h)), csum,
        *(t(v) for v in (x, r, u, p)), z, z, z, z, t(alpha), t(beta))
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[4], want[4], rtol=1e-13, atol=1e-12)


# -- fused_dots ---------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(3, 4096), (30, 2048), (1, 700)])
def test_fused_dots_plain_matches_the_jax_kernel(m, n):
    """Against the Pallas kernel itself (interpret mode on the CPU), each
    coefficient to 1e-12 of the sum of its terms' magnitudes."""
    from repro.kernels import ops as jkops
    rng = np.random.default_rng(m)
    V, z = rng.standard_normal((m, n)), rng.standard_normal(n)
    want = np.asarray(jkops.fused_dots(jnp.asarray(V), jnp.asarray(z)))
    got = ops.fused_dots(torch.from_numpy(V), torch.from_numpy(z))
    assert got.shape == (m,) and got.dtype == torch.float64
    assert np.all(np.abs(got.numpy() - want) <= 1e-12 * np.abs(V * z).sum(-1))
    assert np.allclose(want, np.asarray(ref.fused_dots_ref(V, z)),
                       rtol=1e-12, atol=1e-12)
    eng = get_engine("fused").dots(torch.from_numpy(V), torch.from_numpy(z))
    assert torch.equal(eng, got)
    assert ops.launch_counts()["fused_dots"] == 0


# -- the p-BiCGStab sweep -----------------------------------------------------

def _bicg_state(n, seed):
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal(n) for _ in range(8)]
    return vecs, tuple(rng.uniform(0.2, 0.9, 3))


def _gram_mags(offsets, bands, vecs, scalars, csum):
    """Sum of each payload entry's terms' magnitudes (its rounding scale),
    from the reference oracle's vectors on the same inputs."""
    out = ref.pipebicgstab_fused_ref(offsets, jnp.asarray(bands),
                                     *map(jnp.asarray, vecs), *scalars)
    C = np.stack([np.asarray(out[i]) for i in (1, 2, 3, 5, 6)]
                 + [np.asarray(vecs[7])])
    mags = np.abs(C) @ np.abs(C).T
    chk = np.abs(C[2]).sum() + np.abs(csum * C[1]).sum()
    return np.concatenate([mags, [[chk] + [0.0] * 5]])


def _scalars_t(scalars):
    return [torch.tensor(s, dtype=torch.float64) for s in scalars]


def test_pipebicgstab_fused_plain_matches_ref(op):
    A, T = op
    vecs, sc = _bicg_state(A.n, seed=20)
    want = ref.pipebicgstab_fused_ref(A.offsets, A.bands,
                                      *map(jnp.asarray, vecs), *sc)
    csum = T.column_checksum()
    got = pipebicgstab_fused_plain(T.offsets, T.bands, csum,
                                   *map(torch.from_numpy, vecs),
                                   *_scalars_t(sc))
    for g, w in zip(got[:7], want[:7]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mags = _gram_mags(A.offsets, A.bands, vecs, sc, csum.numpy())
    assert got[7].shape == (7, 6)
    assert np.all(np.abs(got[7].numpy() - np.asarray(want[7]))
                  <= 1e-12 * mags)
    # the wrapper takes the plain version on the CPU and launches nothing
    before = ops.launch_counts()
    again = ops.pipebicgstab_fused_step(T.offsets, T.bands, csum,
                                        *map(torch.from_numpy, vecs),
                                        *_scalars_t(sc))
    for g, w in zip(again, got):
        assert torch.equal(g, w)
    assert ops.launch_counts() == before


def test_pipebicgstab_bf16_storage_narrows_only_the_stores():
    """bf16 chains and bands: loads widen, arithmetic and the payload at
    float64, the six chain stores narrow, r_hat is only read."""
    A = jops.convection_diffusion(200, c=0.5, shift=0.25)   # exact in bf16
    vecs, sc = _bicg_state(A.n, seed=21)
    bf = torch.bfloat16
    t = torch.from_numpy
    chains = [t(v).to(bf) for v in vecs[1:]]
    bands_b = t(np.array(A.bands)).to(bf)
    csum = dia_column_checksum(A.offsets, bands_b.to(torch.float64))
    got = pipebicgstab_fused_plain(A.offsets, bands_b, csum, t(vecs[0]),
                                   *chains, *_scalars_t(sc))
    wide = [vecs[0]] + [c.to(torch.float64).numpy() for c in chains]
    want = ref.pipebicgstab_fused_ref(A.offsets, A.bands,
                                      *map(jnp.asarray, wide), *sc)
    assert got[0].dtype == torch.float64 and got[7].dtype == torch.float64
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:7], want[1:7]):
        assert g.dtype == bf
        np.testing.assert_array_equal(
            g.to(torch.float64).numpy(),
            torch.from_numpy(np.array(w)).to(bf).to(torch.float64).numpy())
    mags = _gram_mags(A.offsets, A.bands, wide, sc, csum.numpy())
    assert np.all(np.abs(got[7].numpy() - np.asarray(want[7]))
                  <= 1e-12 * mags)


def _bicg_rank_operands(A, P, q, vecs):
    """Rank q's halo-sweep operands cut from global vectors: the operator
    rows [lo - h, hi + h) and the w/t/c strips [lo - 2h, lo) and
    [hi, hi + 2h), zero beyond the matrix, as the exchanges give them."""
    h, n = A.halo, A.n
    lo, hi = q * n // P, (q + 1) * n // P
    t = torch.from_numpy
    bands = t(np.ascontiguousarray(
        np.pad(np.asarray(A.bands), ((0, 0), (h, h)))[:, lo:hi + 2 * h]))
    csum = dia_column_checksum(A.offsets, bands, halo=h)
    local = [t(np.ascontiguousarray(v[lo:hi])) for v in vecs]
    strips = []
    for v in (vecs[2], vecs[3], vecs[6]):          # w, t, c
        wide = np.pad(v, (2 * h, 2 * h))
        strips += [t(np.ascontiguousarray(wide[lo:lo + 2 * h])),
                   t(np.ascontiguousarray(wide[hi + 2 * h:hi + 4 * h]))]
    return (bands, csum, *local, *strips), slice(lo, hi)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", ["convdiff", "lap2d", "random"])
def test_pipebicgstab_halo_plain_slices_sum_to_sweep(name, P):
    """P ranks' sweeps on slices of one state equal the one-device plain
    sweep row for row, and their partial payloads sum to its payload (and
    to the reference oracle's)."""
    A = {"convdiff": jops.convection_diffusion(256),
         "lap2d": jops.laplacian_2d(16, 16),
         "random": _random_banded(256, (-3, -1, 0, 2), seed=22)}[name]
    T = convert.dia_from_numpy(A.offsets, np.asarray(A.bands), device="cpu")
    vecs, sc = _bicg_state(A.n, seed=23)
    csum = T.column_checksum()
    whole = pipebicgstab_fused_plain(T.offsets, T.bands, csum,
                                     *map(torch.from_numpy, vecs),
                                     *_scalars_t(sc))
    want = ref.pipebicgstab_fused_ref(A.offsets, A.bands,
                                      *map(jnp.asarray, vecs), *sc)
    mags = _gram_mags(A.offsets, A.bands, vecs, sc, csum.numpy())
    total = np.zeros((7, 6))
    for q in range(P):
        args, rows = _bicg_rank_operands(A, P, q, vecs)
        got = pipebicgstab_halo_plain(A.offsets, *args, *_scalars_t(sc))
        for g, w in zip(got[:7], whole[:7]):
            np.testing.assert_allclose(g.numpy(), w.numpy()[rows],
                                       rtol=1e-13, atol=1e-13)
        total += got[7].numpy()
    assert np.all(np.abs(total - whole[7].numpy()) <= 1e-12 * mags)
    assert np.all(np.abs(total - np.asarray(want[7])) <= 1e-12 * mags)


def test_pipebicgstab_halo_reads_the_neighbour_rows():
    """Rank 1 of 4 needs its neighbours' operator rows and w/t/c strips:
    zeroed or swapped, they change its rows or the summed payload."""
    A = _random_banded(256, (-3, -1, 0, 2), seed=24)
    T = convert.dia_from_numpy(A.offsets, np.asarray(A.bands), device="cpu")
    vecs, sc = _bicg_state(A.n, seed=25)
    s = _scalars_t(sc)
    whole = pipebicgstab_fused_plain(T.offsets, T.bands, T.column_checksum(),
                                     *map(torch.from_numpy, vecs), *s)
    ranks = [_bicg_rank_operands(A, 4, q, vecs) for q in range(4)]
    h = A.halo

    def agrees(args1):
        total = torch.zeros((7, 6), dtype=torch.float64)
        same = True
        for q, (args, rows) in enumerate(ranks):
            got = pipebicgstab_halo_plain(A.offsets, *(args1 if q == 1
                                                       else args), *s)
            same &= all(torch.allclose(g, w[rows], rtol=1e-12, atol=1e-12)
                        for g, w in zip(got[:7], whole[:7]))
            total += got[7]
        return same and torch.allclose(total, whole[7], rtol=1e-12,
                                       atol=1e-10)

    args = ranks[1][0]
    assert agrees(args)
    bands = args[0].clone()
    bands[:, :h] = 0
    bands[:, -h:] = 0
    strips = list(args[10:])
    bad = [(bands,) + args[1:]]
    for i in range(0, 6, 2):                  # swap each lo/hi pair
        sw = list(strips)
        sw[i], sw[i + 1] = sw[i + 1], sw[i]
        bad.append(args[:10] + tuple(sw))
    for b in bad:
        assert not agrees(b)


def test_pipebicgstab_halo_with_no_neighbours_is_the_sweep(op):
    """One rank (zero strips and extension) is the single-device sweep."""
    A, T = op
    vecs, sc = _bicg_state(A.n, seed=26)
    s = _scalars_t(sc)
    h = A.halo
    csum = T.column_checksum()
    tv = list(map(torch.from_numpy, vecs))
    want = pipebicgstab_fused_plain(T.offsets, T.bands, csum, *tv, *s)
    z = torch.zeros(2 * h, dtype=torch.float64)
    got = ops.pipebicgstab_halo_step(
        T.offsets, torch.nn.functional.pad(T.bands, (h, h)), csum, *tv,
        z, z, z, z, z, z, *s)
    for g, w in zip(got[:7], want[:7]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[7], want[7], rtol=1e-13, atol=1e-12)
    assert ops.launch_counts()["pipebicgstab_halo"] == 0


def test_pipebicgstab_wrapper_rejects_devices_without_a_kernel():
    T = convert.dia_from_numpy((-1, 0, 1), np.ones((3, 8)), device="cpu")
    v = torch.zeros(8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pipebicgstab_fused(T.offsets, T.bands, T.bands[0], v, v, v, v, v, v,
                           v, v, 0.1, 0.2, 0.3)


# -- the depth-l ghost-chain sweep -------------------------------------------

def test_band_limit_is_shared_with_the_kernels():
    """H10: the Python and CUDA band limits are one number, and the
    21-band glen operator fits under it."""
    import re
    src = (build.CSRC / "common.cuh").read_text()
    k_max = int(re.search(r"constexpr int kMaxBands = (\d+);", src).group(1))
    assert build.MAX_BANDS == k_max >= 21
    assert len(jops.glen_law_band(64, bandwidth=10).offsets) <= k_max


def _chain_ops():
    return {"tridiag": jops.tridiagonal_laplacian(130),
            "lap2d": jops.laplacian_2d(9, 16),
            "glen": jops.glen_law_band(150, bandwidth=10)}


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("l", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["tridiag", "lap2d", "glen"])
def test_ghost_chain_plain_matches_the_reference_chain(name, l, dt):
    from repro.core.krylov import pipeline as jpipe
    from repro.core.krylov.engine import NaiveEngine
    A = _chain_ops()[name]
    A = jops.DiaMatrix(offsets=A.offsets, bands=A.bands.astype(dt))
    T = convert.dia_from_numpy(A.offsets, np.asarray(A.bands), device="cpu")
    rng = np.random.default_rng(20)
    p, r = (rng.standard_normal(A.n).astype(dt) for _ in range(2))
    theta = np.asarray(jpipe.dia_inf_norm(A))
    C, G = jpipe._ghost_chain(A, jnp.asarray(p), jnp.asarray(r),
                              jnp.asarray(theta), l, NaiveEngine())
    C, G = np.asarray(C, np.float64), np.asarray(G, np.float64)
    Ct, Gt = ghost_chain_fused_plain(T.offsets, T.bands, torch.from_numpy(p),
                                     torch.from_numpy(r),
                                     torch.from_numpy(theta), l)
    assert Ct.shape == (2 * l + 1, A.n) and Ct.dtype == getattr(torch, dt)
    assert Gt.shape == (2 * l + 1, 2 * l + 1)
    ctol, gtol = (1e-14, 1e-12) if dt == "float64" else (1e-6, 1e-5)
    assert np.abs(Ct.double().numpy() - C).max() <= ctol * np.abs(C).max()
    mags = np.abs(C) @ np.abs(C).T
    assert np.all(np.abs(Gt.double().numpy() - G) <= gtol * mags)
    # the wrapper takes the plain version on the CPU and launches nothing
    before = ghost_chain_fused.launches
    again = ops.ghost_chain_step(T.offsets, T.bands, torch.from_numpy(p),
                                 torch.from_numpy(r),
                                 torch.from_numpy(theta), l)
    assert ghost_chain_fused.launches == before
    assert torch.equal(again[0], Ct) and torch.equal(again[1], Gt)


def _chain_rank_operands(offsets, bands, p, r, l, P, q):
    """Rank q of P's chain operands: the operator rows [lo - lh, hi + lh)
    and the p/r strips [lo - lh, lo), [hi, hi + lh), zero beyond the
    matrix, as the exchanges give them."""
    H = l * max(abs(o) for o in offsets)
    n = p.shape[-1]
    lo, hi = q * n // P, (q + 1) * n // P
    pad = torch.nn.functional.pad
    ext = pad(bands, (H, H))[:, lo:hi + 2 * H].contiguous()
    strips = []
    for v in (p, r):
        w = pad(v, (H, H))
        strips += [w[lo:lo + H], w[hi + H:hi + 2 * H]]
    return (ext, p[lo:hi], r[lo:hi], *strips), slice(lo, hi)


@pytest.mark.parametrize("l", [1, 2, 4])
@pytest.mark.parametrize("name", ["tridiag", "lap2d", "glen", "random"])
def test_ghost_chain_halo_slices_equal_the_chain(name, l):
    """4 ranks' chain sweeps on slices of one state: each chain equals the
    one-device plain chain's rows bit for bit; the partial Grams sum to
    its Gram to 1e-12 of the terms' magnitudes."""
    A = dict(_chain_ops(), random=_random_banded(
        256, (-3, -1, 0, 2), seed=21))[name]
    T = convert.dia_from_numpy(A.offsets, np.asarray(A.bands), device="cpu")
    rng = np.random.default_rng(22)
    p, r = (torch.from_numpy(rng.standard_normal(A.n)) for _ in range(2))
    theta = 2.5
    C, G = ghost_chain_fused_plain(T.offsets, T.bands, p, r, theta, l)
    total = torch.zeros_like(G)
    P = 4 if 2 * l * A.halo <= A.n // 4 else 2
    for q in range(P):
        args, rows = _chain_rank_operands(T.offsets, T.bands, p, r, l, P, q)
        Cq, Gq = ghost_chain_halo_plain(T.offsets, *args, theta, l)
        assert torch.equal(Cq, C[:, rows])
        total = total + Gq
    mags = C.abs() @ C.abs().T
    assert bool(((total - G).abs() <= 1e-12 * mags).all())
    # the operator extension and the strips are read
    args, _ = _chain_rank_operands(T.offsets, T.bands, p, r, l, P, 1)
    cut = list(args)
    cut[3] = torch.zeros_like(cut[3])            # p_lo
    assert not torch.equal(ghost_chain_halo_plain(T.offsets, *cut, theta,
                                                  l)[0],
                           ghost_chain_halo_plain(T.offsets, *args, theta,
                                                  l)[0])


def test_ghost_chain_bf16_storage_narrows_only_the_store():
    """bf16 p, r and bands: the links run at float32, only C narrows, and
    the Gram is that of the chain before the store narrows it."""
    T = convert.dia_from_numpy((-1, 0, 1), np.asarray(
        jops.convection_diffusion(300).bands), device="cpu")
    rng = np.random.default_rng(23)
    bf = torch.bfloat16
    p, r = (torch.from_numpy(rng.standard_normal(300)).to(bf)
            for _ in range(2))
    bands = T.bands.to(bf)
    C, G = ghost_chain_fused_plain(T.offsets, bands, p, r, 3.3, 2)
    wide, Gw = ghost_chain_fused_plain(T.offsets, bands.float(), p.float(),
                                       r.float(), 3.3, 2)
    assert C.dtype == bf and G.dtype == torch.float32
    assert torch.equal(C, wide.to(bf))
    assert torch.equal(G, Gw)
    Cn = C.float()
    assert not torch.allclose(Cn @ Cn.T, G, rtol=1e-6, atol=0)
    C64, G64 = ghost_chain_halo_plain(
        T.offsets, torch.nn.functional.pad(bands, (2, 2)), p, r,
        *(torch.zeros(2, dtype=bf) for _ in range(4)), 3.3, 2,
        accum_dtype=torch.float64)
    assert C64.dtype == bf and G64.dtype == torch.float64


def test_chain_plan_picks_the_workspace():
    """Shared memory where every link's window buffer fits, the global
    scratch otherwise (laplacian_2d(1448, 1448) at l = 4 in float64);
    tiles fill whole 1024-slot batches: one for ex23 (1020 rows at l =
    2), eight for laplacian_2d(1448, 1448) at l = 2 (2400 rows), two for
    laplacian_2d(70, 50) at l = 8 (928 rows in float64, 1952 in
    float32, both in shared memory now that no link is kept twice)."""
    assert chain_plan(2, 5, 8) == (1020, 5 * 1020 + 8, True)
    tile, ws, shared = chain_plan(2 * 1448, 5, 8)
    assert (tile, shared) == (2400, True) and ws * 8 <= build.SMEM_DYNAMIC
    assert ws * 8 <= SWEEP_SMEM_LIMIT
    assert chain_plan(4 * 1448, 9, 8)[2] is False
    assert chain_plan(8 * 70, 17, 8) == (928, 17 * 928 + 2 * 560 * 8, True)
    assert chain_plan(8 * 70, 17, 4)[:3:2] == (1952, True)


def test_chain_wrappers_reject_what_has_no_kernel():
    T = convert.dia_from_numpy((-1, 0, 1), np.ones((3, 8)), device="cpu")
    meta = torch.zeros(8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ghost_chain_fused(T.offsets, T.bands.to("meta"), meta, meta, 2.0, 2)
    with pytest.raises(ValueError, match="operands on"):
        ghost_chain_fused(T.offsets, T.bands, torch.zeros(8).double(),
                          meta, 2.0, 2)
    z = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="chain reach"):
        ops.ghost_chain_halo_step(T.offsets, torch.zeros(3, 12), z[:3],
                                  z[:3], z[:2], z[:2], z[:2], z[:2], 2.0, 2)
    assert ghost_chain_halo.launches == 0
