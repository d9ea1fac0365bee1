"""The port's kernel modules against the JAX reference oracles.

On the CPU each wrapper takes its plain torch version, which is held
against ``repro/kernels/ref.py`` on the same numpy inputs (float64, rtol
and atol 1e-12).  tests/test_torch_cuda.py holds the CUDA kernels against
the plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.krylov import operators as jops
from repro.kernels import ref
from repro.kernels.checksum import dia_column_checksum as j_checksum
from repro_torch import convert
from repro_torch.kernels import build, ops
from repro_torch.kernels.checksum import dia_column_checksum
from repro_torch.kernels.pipecg_spmv_fused import pipecg_spmv_fused_plain
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
        "pipecg_fused.cu", "pipecg_spmv_fused.cu", "spmv_dia.cu"]
