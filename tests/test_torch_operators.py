"""The PyTorch port's operators against the JAX reference.

Same numpy inputs go to both packages; the port's operator is rebuilt from
the reference's bands with ``convert.dia_from_numpy``.  The band fold is
the same in both, so matvec, diagonal, to_dense and the column checksum
must agree exactly, and fingerprints byte for byte.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.krylov import operators as jops
from repro.kernels.checksum import dia_column_checksum as j_checksum
from repro_torch import convert
from repro_torch.core.krylov import operators as tops
from repro_torch.core.krylov.operator import (HaloSpec, SparseOperator,
                                              as_operator,
                                              reset_operator_deprecation_warning)
from repro_torch.kernels.checksum import dia_column_checksum as t_checksum

# (name, reference factory, port factory); the port builds on the CPU
FACTORIES = [
    ("tridiag", lambda: jops.tridiagonal_laplacian(97),
     lambda: tops.tridiagonal_laplacian(97, device="cpu")),
    ("tridiag_f32", lambda: jops.tridiagonal_laplacian(64, jnp.float32),
     lambda: tops.tridiagonal_laplacian(64, torch.float32, device="cpu")),
    ("lap2d", lambda: jops.laplacian_2d(12, 9),
     lambda: tops.laplacian_2d(12, 9, device="cpu")),
    ("convdiff", lambda: jops.convection_diffusion(80),
     lambda: tops.convection_diffusion(80, device="cpu")),
]


def _port(A):
    return convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                  grid_shape=A.grid_shape, device="cpu")


@pytest.fixture(scope="module", params=[
    "tridiag", "lap2d", "convdiff", "glen9"])
def pair(request):
    """(reference operator, port operator) from the same bands."""
    if request.param == "glen9":
        A = jops.glen_law_band(120, bandwidth=4, seed=3)
    else:
        A = dict((n, j) for n, j, _ in FACTORIES)[request.param]()
    return A, _port(A)


@pytest.mark.parametrize("name", [b[0] for b in FACTORIES])
def test_factories_byte_identical(name):
    _, jb, tb = next(b for b in FACTORIES if b[0] == name)
    A, T = jb(), tb()
    assert T.offsets == tuple(A.offsets)
    assert T.grid_shape == A.grid_shape
    np.testing.assert_array_equal(T.bands.numpy(), np.asarray(A.bands))
    assert T.fingerprint() == A.fingerprint()


def test_fingerprint_survives_conversion(pair):
    A, T = pair
    assert T.fingerprint() == A.fingerprint()
    assert T.structure_key() == A.structure_key()


def test_matvec_exact(pair):
    A, T = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.n)
    X = rng.standard_normal((3, A.n))
    np.testing.assert_array_equal(T.matvec(torch.from_numpy(x)).numpy(),
                                  np.asarray(A.matvec(jnp.asarray(x))))
    np.testing.assert_array_equal(T.matvec(torch.from_numpy(X)).numpy(),
                                  np.asarray(A.matvec(jnp.asarray(X))))


@pytest.mark.parametrize("name", ["tridiag", "lap2d"])
def test_to_dense_exact(name):
    _, jb, tb = next(b for b in FACTORIES if b[0] == name)
    np.testing.assert_array_equal(tb().to_dense().numpy(),
                                  np.asarray(jb().to_dense()))


def test_diagonal_checksum_norm_exact(pair):
    A, T = pair
    np.testing.assert_array_equal(T.diagonal().numpy(),
                                  np.asarray(A.diagonal()))
    np.testing.assert_array_equal(T.column_checksum().numpy(),
                                  np.asarray(A.column_checksum()))
    assert T.inf_norm() == A.inf_norm()
    assert T.words_per_iter() == A.words_per_iter()


def test_checksum_with_halo_exact():
    A = jops.laplacian_2d(7, 6)
    h = A.halo
    ext = np.pad(np.asarray(A.bands), ((0, 0), (h, h)))
    ext[:, :h] = 0.5
    ext[:, -h:] = -0.25
    want = j_checksum(A.offsets, jnp.asarray(ext), halo=h)
    got = t_checksum(A.offsets, torch.from_numpy(ext), halo=h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_halo_spec_matches(pair):
    A, T = pair
    assert T.halo_spec() == HaloSpec(A.halo_spec().ndim,
                                     A.halo_spec().neighbors,
                                     A.halo_spec().widths)
    assert T.halo == A.halo


def test_grid_offsets_and_errors():
    T = tops.laplacian_2d(5, 4, device="cpu")
    A = jops.laplacian_2d(5, 4)
    assert T.grid_offsets() == A.grid_offsets()
    with pytest.raises(ValueError, match="grid_shape"):
        tops.tridiagonal_laplacian(8, device="cpu").grid_offsets()


def test_protocol_and_preconditioners():
    T = tops.tridiagonal_laplacian(16, device="cpu")
    assert isinstance(T, SparseOperator)
    r = torch.arange(16, dtype=torch.float64)
    assert torch.equal(tops.jacobi_preconditioner(T)(r), r / 2.0)
    assert torch.equal(tops.identity_preconditioner()(r), r)
    mf = tops.MatFreeOperator(fn=T.matvec, n=16)
    assert torch.equal(mf.matvec(r), T.matvec(r))


def test_as_operator_legacy_pair_warns_once():
    reset_operator_deprecation_warning()
    T = tops.tridiagonal_laplacian(10, device="cpu")
    with pytest.warns(DeprecationWarning, match="DiaMatrix"):
        op = as_operator(T.offsets, T.bands)
    assert op.fingerprint() == T.fingerprint()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        as_operator((T.offsets, T.bands))
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert as_operator(T) is T
    reset_operator_deprecation_warning()


def test_factories_default_to_the_card():
    """No device= means the card: without one the factory raises."""
    if torch.cuda.is_available():
        assert tops.tridiagonal_laplacian(64).bands.device.type == "cuda"
        assert tops.glen_law_band(64).bands.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tops.tridiagonal_laplacian(64)
    with pytest.raises((RuntimeError, AssertionError)):
        tops.glen_law_band(64)


def test_glen_law_band_structure():
    """The port's ex48 stand-in has the reference's structure (its values
    come from a torch.Generator, not jax.random): 21 sorted offsets,
    symmetric, diagonally dominant by exactly 1 (so SPD), zero past the
    edges, and the same bands for the same seed."""
    n, bw = 300, 10
    A = tops.glen_law_band(n, bandwidth=bw, seed=3, device="cpu")
    assert A.offsets == tuple(range(-bw, bw + 1)) and len(A.offsets) == 21
    assert A.dtype == torch.float64
    D = A.to_dense()
    assert torch.equal(D, D.T)
    off_sum = D.abs().sum(1) - D.diagonal().abs()
    torch.testing.assert_close(D.diagonal() - off_sum,
                               torch.ones(n, dtype=torch.float64),
                               rtol=0, atol=1e-13)
    assert float(torch.linalg.eigvalsh(D).min()) > 0.5
    for k, off in enumerate(A.offsets):
        edge = A.bands[k, n - off:] if off > 0 else A.bands[k, :-off]
        assert bool((edge == 0).all())
        if off:
            inner = A.bands[k, :n - off] if off > 0 else A.bands[k, -off:]
            assert bool((inner < 0).all())
    again = tops.glen_law_band(n, bandwidth=bw, seed=3, device="cpu")
    assert again.fingerprint() == A.fingerprint()
    assert tops.glen_law_band(n, bandwidth=bw, seed=4, device="cpu") \
        .fingerprint() != A.fingerprint()
    f32 = tops.glen_law_band(n, bandwidth=3, dtype=torch.float32,
                             device="cpu")
    assert f32.dtype == torch.float32 and len(f32.offsets) == 7
