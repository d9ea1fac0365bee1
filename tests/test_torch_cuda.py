"""The CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU and nvcc; every test skips (from a fixture) without
one.  The file imports neither JAX nor the reference package, so it runs
on a machine that has only the port's requirements:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Vectors must agree bit for bit (the kernels round as the plain versions
do); the reduction partials, summed in another order, to 1e-10 (float64)
and 1e-5 (float32 accumulation) of the sum of their terms' magnitudes.
"""
import pytest
import torch

from repro_torch.kernels.checksum import dia_column_checksum
from repro_torch.kernels.pipecg_fused import pipecg_fused, pipecg_fused_plain
from repro_torch.kernels.pipecg_spmv_fused import (pipecg_spmv_fused,
                                                   pipecg_spmv_fused_plain)
from repro_torch.kernels.spmv_dia import spmv_dia, spmv_dia_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("acc,sto", [
    (torch.float64, torch.float64), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_kernels_match_plain_on_card(cuda, acc, sto):
    from repro_torch.core.krylov import laplacian_2d, tridiagonal_laplacian
    g = torch.Generator(device=cuda).manual_seed(0)
    for A in (tridiagonal_laplacian(5000), laplacian_2d(70, 50)):
        k, n = 3, A.n
        x = torch.randn(k, n, generator=g, device=cuda, dtype=acc)
        r, u, p = (torch.randn(k, n, generator=g, device=cuda,
                               dtype=acc).to(sto) for _ in range(3))
        a, b = (torch.rand(k, generator=g, device=cuda, dtype=acc)
                for _ in range(2))
        bands = A.bands.to(sto)
        invd = (1.0 / A.diagonal()).to(sto)
        csum = dia_column_checksum(A.offsets, bands)
        got = pipecg_spmv_fused(A.offsets, bands, invd, csum, x, r, u, p, a, b)
        want = pipecg_spmv_fused_plain(A.offsets, bands, invd, csum,
                                       x, r, u, p, a, b)
        torch.cuda.synchronize()
        for gv, wv in zip(got[:4], want[:4]):
            assert torch.equal(gv, wv)
        # the partials run in another summation order: each is held
        # relative to the sum of its terms' magnitudes (the checksum entry
        # is a rounding-level difference of two large sums)
        u2, r2 = want[2].to(acc), want[1].to(acc)
        w2 = spmv_dia_plain(A.offsets, bands.to(acc), u2)
        mags = torch.stack(
            [t.abs().sum(-1) for t in (r2 * u2, w2 * u2, r2 * r2, r2 * w2,
                                       w2 * w2)]
            + [w2.abs().sum(-1) + (csum.to(acc) * u2).abs().sum(-1)], -1)
        rel = float(((got[4] - want[4]).abs() / mags).max())
        assert rel <= (1e-10 if acc == torch.float64 else 1e-5)
        assert torch.equal(spmv_dia(A.offsets, bands, x),
                           spmv_dia_plain(A.offsets, bands, x))
        if sto == acc:
            vs = [torch.randn(k, n, generator=g, device=cuda, dtype=acc)
                  for _ in range(10)]
            got = pipecg_fused(*vs, a, b)
            want = pipecg_fused_plain(*vs, a, b)
            for gv, wv in zip(got[:8], want[:8]):
                assert torch.equal(gv, wv)


@pytest.mark.cuda
def test_fused_solve_on_card_matches_naive(cuda):
    from repro_torch.core.krylov import (SolverOptions, pipecg,
                                         tridiagonal_laplacian)
    from repro_torch.kernels import ops
    A = tridiagonal_laplacian(4096)
    b = torch.randn(4096, generator=torch.Generator(device=cuda)
                    .manual_seed(1), device=cuda, dtype=torch.float64)
    before = ops.launch_counts()
    fused = pipecg(A, b, options=SolverOptions(engine="fused", maxiter=60))
    after = ops.launch_counts()
    assert after["pipecg_spmv_fused"] - before["pipecg_spmv_fused"] == 60
    assert after["spmv_dia"] - before["spmv_dia"] == 2
    naive = pipecg(A, b, options=SolverOptions(engine="naive", maxiter=60))
    torch.testing.assert_close(fused.res_history, naive.res_history,
                               rtol=1e-10, atol=0)
