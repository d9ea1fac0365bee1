"""The CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU and nvcc; every test skips (from a fixture) without
one.  The file imports neither JAX nor the reference package, so it runs
on a machine that has only the port's requirements:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Vectors must agree bit for bit (the kernels round as the plain versions
do); the reduction partials, summed in another order, to 1e-10 (float64)
and 1e-5 (float32 accumulation) of the sum of their terms' magnitudes, as
``fused_dots``'s coefficients to 1e-12 and 1e-5.  The ghost-chain sweep's
chains bit for bit (bf16 ones too: the links run at float32 in both), its
Gram as the partials.  The 21-band glen operator (H10) runs through every
sweep.  The BSR kernels run on ``dia_to_bsr`` of the 1-D and 2-D
Laplacians at bs 2, 4 and 8 (bs 3 through the SpMV only: the sweep
takes powers of two).
"""
import pytest
import torch

from repro_torch.kernels.checksum import dia_column_checksum
from repro_torch.kernels.fused_dots import fused_dots, fused_dots_plain
from repro_torch.kernels.pipebicgstab_fused import (pipebicgstab_fused,
                                                    pipebicgstab_fused_plain,
                                                    pipebicgstab_halo,
                                                    pipebicgstab_halo_plain)
from repro_torch.kernels.pipecg_fused import pipecg_fused, pipecg_fused_plain
from repro_torch.kernels.pipecg_spmv_fused import (ghost_chain_fused,
                                                   ghost_chain_fused_plain,
                                                   ghost_chain_halo,
                                                   ghost_chain_halo_plain,
                                                   pipecg_spmv_fused,
                                                   pipecg_spmv_fused_plain,
                                                   pipecg_spmv_halo,
                                                   pipecg_spmv_halo_plain)
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


@pytest.mark.cuda
@pytest.mark.parametrize("acc,sto", [
    (torch.float64, torch.float64), (torch.float32, torch.bfloat16)])
def test_halo_kernel_matches_plain_on_card(cuda, acc, sto):
    """An interior rank's sweep with random neighbour strips and a random
    operator extension (every band entry random, so a row read from the
    wrong place changes the result)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    offsets = (-3, -1, 0, 2)
    h, k, n = 3, 3, 4000

    def rnd(*shape, dt=acc):
        return torch.randn(*shape, generator=g, device=cuda,
                           dtype=torch.float64).to(dt)

    bands = rnd(len(offsets), n + 2 * h, dt=torch.float64)
    bands[offsets.index(0)] = bands[offsets.index(0)].abs() + 2.0
    invd = (1.0 / bands[offsets.index(0)]).to(sto)
    bands = bands.to(sto)
    csum = dia_column_checksum(offsets, bands, halo=h)
    x = rnd(k, n)
    r, u, p = (rnd(k, n, dt=sto) for _ in range(3))
    strips = [rnd(k, 2 * h, dt=sto) for _ in range(4)]
    a = torch.rand(k, generator=g, device=cuda, dtype=acc)
    b = torch.rand(k, generator=g, device=cuda, dtype=acc)
    args = (offsets, bands, invd, csum, x, r, u, p, *strips, a, b)
    got = pipecg_spmv_halo(*args)
    want = pipecg_spmv_halo_plain(*args)
    torch.cuda.synchronize()
    for gv, wv in zip(got[:4], want[:4]):
        assert torch.equal(gv, wv)
    rel = float(((got[4] - want[4]).abs()
                 / want[4].abs().clamp(min=1.0)).max())
    assert rel <= (1e-10 if acc == torch.float64 else 1e-3)
    # the extension is read: zeroing it changes the partials
    cut = bands.clone()
    cut[:, :h] = 0
    cut[:, -h:] = 0
    moved = pipecg_spmv_halo(offsets, cut, *args[2:])[4]
    assert not torch.allclose(moved, got[4])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_fused_dots_matches_plain_on_card(cuda, dt):
    g = torch.Generator(device=cuda).manual_seed(3)
    for m, n in ((1, 1), (3, 5000), (30, 70001)):
        V = torch.randn(m, n, generator=g, device=cuda, dtype=dt)
        z = torch.randn(n, generator=g, device=cuda, dtype=dt)
        got = fused_dots(V, z)
        want = fused_dots_plain(V, z)
        torch.cuda.synchronize()
        mags = (V * z).abs().sum(-1)
        tol = 1e-12 if dt == torch.float64 else 1e-5
        assert bool(((got - want).abs() <= tol * mags + 1e-30).all())


def _gram_rel(got, want, C, csum):
    """Largest payload gap relative to the sum of its terms' magnitudes."""
    mags = C.abs() @ C.abs().T
    chk = C[2].abs().sum() + (csum * C[1]).abs().sum()
    mags = torch.cat([mags, torch.zeros_like(mags[:1])])
    mags[6, 0] = chk
    tiny = torch.finfo(mags.dtype).tiny
    return float(((got - want).abs() / mags.clamp(min=tiny)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("acc,sto", [
    (torch.float64, torch.float64), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_pipebicgstab_kernel_matches_plain_on_card(cuda, acc, sto):
    from repro_torch.core.krylov import convection_diffusion, laplacian_2d
    g = torch.Generator(device=cuda).manual_seed(4)
    for A in (convection_diffusion(5000), laplacian_2d(70, 50)):
        n = A.n
        x = torch.randn(n, generator=g, device=cuda, dtype=acc)
        chains = [torch.randn(n, generator=g, device=cuda,
                              dtype=acc).to(sto) for _ in range(7)]
        sc = [torch.rand((), generator=g, device=cuda, dtype=acc)
              for _ in range(3)]
        bands = A.bands.to(sto)
        csum = dia_column_checksum(A.offsets, bands.to(acc))
        args = (A.offsets, bands, csum, x, *chains, *sc)
        got = pipebicgstab_fused(*args)
        want = pipebicgstab_fused_plain(*args)
        torch.cuda.synchronize()
        for gv, wv in zip(got[:7], want[:7]):
            assert torch.equal(gv, wv)
        C = torch.stack([want[i].to(acc) for i in (1, 2, 3, 5, 6)]
                        + [chains[6].to(acc)])
        rel = _gram_rel(got[7], want[7], C, csum)
        assert rel <= (1e-10 if acc == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("acc,sto", [
    (torch.float64, torch.float64), (torch.float32, torch.bfloat16)])
def test_pipebicgstab_halo_kernel_matches_plain_on_card(cuda, acc, sto):
    """An interior rank with random strips and a random operator
    extension; zeroing the extension changes the payload."""
    g = torch.Generator(device=cuda).manual_seed(5)
    offsets = (-3, -1, 0, 2)
    h, n = 3, 4000

    def rnd(*shape, dt=acc):
        return torch.randn(*shape, generator=g, device=cuda,
                           dtype=torch.float64).to(dt)

    bands = rnd(len(offsets), n + 2 * h, dt=torch.float64)
    bands[offsets.index(0)] = bands[offsets.index(0)].abs() + 2.0
    csum = dia_column_checksum(offsets, bands, halo=h).to(acc)
    bands = bands.to(sto)
    x = rnd(n)
    chains = [rnd(n, dt=sto) for _ in range(7)]
    strips = [rnd(2 * h, dt=sto) for _ in range(6)]
    sc = [torch.rand((), generator=g, device=cuda, dtype=acc)
          for _ in range(3)]
    args = (offsets, bands, csum, x, *chains, *strips, *sc)
    got = pipebicgstab_halo(*args)
    want = pipebicgstab_halo_plain(*args)
    torch.cuda.synchronize()
    for gv, wv in zip(got[:7], want[:7]):
        assert torch.equal(gv, wv)
    rel = float(((got[7] - want[7]).abs()
                 / want[7].abs().clamp(min=1.0)).max())
    assert rel <= (1e-10 if acc == torch.float64 else 1e-3)
    cut = bands.clone()
    cut[:, :h] = 0
    cut[:, -h:] = 0
    moved = pipebicgstab_halo(offsets, cut, *args[2:])[7]
    assert not torch.allclose(moved, got[7])


@pytest.mark.cuda
def test_pipebicgstab_fused_solve_on_card_matches_naive(cuda):
    from repro_torch.core.krylov import (SolverOptions, convection_diffusion,
                                         pipebicgstab)
    from repro_torch.kernels import ops
    A = convection_diffusion(4096)
    b = torch.randn(4096, generator=torch.Generator(device=cuda)
                    .manual_seed(6), device=cuda, dtype=torch.float64)
    before = ops.launch_counts()
    fused = pipebicgstab(A, b, options=SolverOptions(
        engine="fused", maxiter=20, M="jacobi"))
    after = ops.launch_counts()
    assert after["pipebicgstab_fused"] - before["pipebicgstab_fused"] == 20
    assert after["spmv_dia"] == before["spmv_dia"]
    naive = pipebicgstab(A, b, options=SolverOptions(
        engine="naive", maxiter=20, M="jacobi"))
    torch.testing.assert_close(fused.res_history, naive.res_history,
                               rtol=1e-10, atol=0)


def _glen(n, cuda):
    from repro_torch.core.krylov import glen_law_band
    return glen_law_band(n, bandwidth=10, device=cuda)


@pytest.mark.cuda
def test_sweeps_run_21_bands_on_card(cuda):
    """H10: spmv_dia, the PIPECG sweep and the p-BiCGStab sweep take the
    21-band glen operator and equal their plain versions."""
    A = _glen(6000, cuda)
    assert len(A.offsets) == 21
    g = torch.Generator(device=cuda).manual_seed(7)
    k, n = 2, A.n
    x, r, u, p = (torch.randn(k, n, generator=g, device=cuda,
                              dtype=torch.float64) for _ in range(4))
    a, b = (torch.rand(k, generator=g, device=cuda, dtype=torch.float64)
            for _ in range(2))
    invd = 1.0 / A.diagonal()
    csum = dia_column_checksum(A.offsets, A.bands)
    assert torch.equal(spmv_dia(A.offsets, A.bands, x),
                       spmv_dia_plain(A.offsets, A.bands, x))
    got = pipecg_spmv_fused(A.offsets, A.bands, invd, csum, x, r, u, p, a, b)
    want = pipecg_spmv_fused_plain(A.offsets, A.bands, invd, csum,
                                   x, r, u, p, a, b)
    torch.cuda.synchronize()
    for gv, wv in zip(got[:4], want[:4]):
        assert torch.equal(gv, wv)
    rel = float(((got[4] - want[4]).abs()
                 / want[4].abs().clamp(min=1.0)).max())
    assert rel <= 1e-10
    chains = [torch.randn(n, generator=g, device=cuda, dtype=torch.float64)
              for _ in range(7)]
    sc = [torch.rand((), generator=g, device=cuda, dtype=torch.float64)
          for _ in range(3)]
    args = (A.offsets, A.bands, csum, x[0], *chains, *sc)
    got = pipebicgstab_fused(*args)
    want = pipebicgstab_fused_plain(*args)
    torch.cuda.synchronize()
    for gv, wv in zip(got[:7], want[:7]):
        assert torch.equal(gv, wv)
    C = torch.stack([want[i] for i in (1, 2, 3, 5, 6)] + [chains[6]])
    assert _gram_rel(got[7], want[7], C, csum) <= 1e-10


def _chain_gram_rel(got, want, C):
    mags = C.abs() @ C.abs().T
    return float(((got - want).abs()
                  / mags.clamp(min=torch.finfo(mags.dtype).tiny)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 2, 4, 8])
@pytest.mark.parametrize("acc,sto", [
    (torch.float64, torch.float64), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_ghost_chain_kernel_matches_plain_on_card(cuda, l, acc, sto):
    """On ex23, laplacian_2d and glen (ragged tiles: n is no multiple of
    the tile); laplacian_2d at l = 8 in float64 runs the global-memory
    workspace (tests/test_torch_kernels.py::test_chain_plan_picks_the_
    workspace), the others the shared one."""
    from repro_torch.core.krylov import laplacian_2d, tridiagonal_laplacian
    g = torch.Generator(device=cuda).manual_seed(8)
    for A in (tridiagonal_laplacian(5001, device=cuda),
              laplacian_2d(70, 50, device=cuda), _glen(3001, cuda)):
        bands = A.bands.to(sto)
        p, r = (torch.randn(A.n, generator=g, device=cuda,
                            dtype=torch.float64).to(sto) for _ in range(2))
        theta = torch.tensor(3.7, dtype=torch.float64, device=cuda)
        want = ghost_chain_fused_plain(A.offsets, bands, p, r, theta, l,
                                       accum_dtype=acc)
        got = ghost_chain_fused(A.offsets, bands, p, r, theta, l,
                                accum_dtype=acc)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        wide = ghost_chain_fused_plain(A.offsets, bands.to(acc), p.to(acc),
                                       r.to(acc), theta, l)[0]
        rel = _chain_gram_rel(got[1], want[1], wide)
        assert rel <= (1e-10 if acc == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("acc,sto", [
    (torch.float64, torch.float64), (torch.float32, torch.bfloat16)])
def test_ghost_chain_halo_kernel_matches_plain_on_card(cuda, acc, sto):
    """An interior rank with random strips and a random operator
    extension; zeroing the extension changes the Gram."""
    g = torch.Generator(device=cuda).manual_seed(9)
    offsets = (-3, -1, 0, 2)
    h, n, l = 3, 4000, 2
    H = l * h

    def rnd(*shape, dt=sto):
        return torch.randn(*shape, generator=g, device=cuda,
                           dtype=torch.float64).to(dt)

    bands = rnd(len(offsets), n + 2 * H)
    p, r = rnd(n), rnd(n)
    strips = [rnd(H) for _ in range(4)]
    args = (offsets, bands, p, r, *strips, 2.9, l)
    got = ghost_chain_halo(*args, accum_dtype=acc)
    want = ghost_chain_halo_plain(*args, accum_dtype=acc)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    rel = float(((got[1] - want[1]).abs()
                 / want[1].abs().clamp(min=1.0)).max())
    assert rel <= (1e-10 if acc == torch.float64 else 1e-3)
    cut = bands.clone()
    cut[:, :H] = 0
    cut[:, -H:] = 0
    moved = ghost_chain_halo(offsets, cut, *args[2:], accum_dtype=acc)[1]
    assert not torch.allclose(moved, got[1])


@pytest.mark.cuda
def test_depth_solve_on_card_matches_naive(cuda):
    from repro_torch.core.krylov import (SolverOptions, pipecg_l,
                                         tridiagonal_laplacian)
    from repro_torch.kernels import ops
    A = tridiagonal_laplacian(4096, device=cuda)
    b = torch.randn(4096, generator=torch.Generator(device=cuda)
                    .manual_seed(10), device=cuda, dtype=torch.float64)
    for l in (2, 4):
        before = ops.launch_counts()
        fused = pipecg_l(A, b, options=SolverOptions(engine="fused",
                                                     maxiter=60, depth=l))
        after = ops.launch_counts()
        assert after["ghost_chain_fused"] - before["ghost_chain_fused"] \
            == 60 // l
        assert after["spmv_dia"] == before["spmv_dia"]
        naive = pipecg_l(A, b, options=SolverOptions(engine="naive",
                                                     maxiter=60, depth=l))
        torch.testing.assert_close(fused.res_history, naive.res_history,
                                   rtol=1e-10, atol=0)


def _bsr_operands(A, bs, k, acc, g, cuda):
    from repro_torch.core.krylov import dia_to_bsr
    B = dia_to_bsr(A, bs=bs)
    B = type(B)(indices=B.indices, blocks=B.blocks.to(acc))
    x, r, u, p = (torch.randn(k, B.n, generator=g, device=cuda, dtype=acc)
                  for _ in range(4))
    a, b = (torch.rand(k, generator=g, device=cuda, dtype=acc)
            for _ in range(2))
    invd = (1.0 / B.diagonal()).contiguous()
    return B, (B.indices, B.blocks, invd, B.column_checksum(), x, r, u, p,
               a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("acc", [torch.float64, torch.float32])
@pytest.mark.parametrize("bs", [2, 4, 8])
def test_bsr_kernels_match_plain_on_card(cuda, bs, acc):
    from repro_torch.core.krylov import laplacian_2d, tridiagonal_laplacian
    from repro_torch.kernels.spmv_bsr import (pipecg_bsr_fused,
                                              pipecg_bsr_fused_plain,
                                              spmv_bsr, spmv_bsr_plain)
    g = torch.Generator(device=cuda).manual_seed(11)
    for A in (tridiagonal_laplacian(4096, device=cuda),
              laplacian_2d(72, 50, device=cuda)):
        B, args = _bsr_operands(A, bs, 3, acc, g, cuda)
        x = args[4]
        for v in (x, x[0]):
            assert torch.equal(spmv_bsr(B.indices, B.blocks, v),
                               spmv_bsr_plain(B.indices, B.blocks, v))
        got = pipecg_bsr_fused(*args)
        want = pipecg_bsr_fused_plain(*args)
        torch.cuda.synchronize()
        for gv, wv in zip(got[:4], want[:4]):
            assert torch.equal(gv, wv)
        u2, r2 = want[2], want[1]
        w2 = spmv_bsr_plain(B.indices, B.blocks, u2)
        mags = torch.stack(
            [t.abs().sum(-1) for t in (r2 * u2, w2 * u2, r2 * r2, r2 * w2,
                                       w2 * w2)]
            + [w2.abs().sum(-1) + (args[3] * u2).abs().sum(-1)], -1)
        rel = float(((got[4] - want[4]).abs() / mags).max())
        assert rel <= (1e-10 if acc == torch.float64 else 1e-5)


@pytest.mark.cuda
def test_bsr_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.core.krylov import dia_to_bsr, tridiagonal_laplacian
    from repro_torch.kernels.spmv_bsr import (pipecg_bsr_fused, spmv_bsr,
                                              spmv_bsr_plain)
    g = torch.Generator(device=cuda).manual_seed(12)
    B3 = dia_to_bsr(tridiagonal_laplacian(300, device=cuda), bs=3)
    x = torch.randn(300, generator=g, device=cuda, dtype=torch.float64)
    assert torch.equal(spmv_bsr(B3.indices, B3.blocks, x),
                       spmv_bsr_plain(B3.indices, B3.blocks, x))
    _, args = _bsr_operands(tridiagonal_laplacian(300, device=cuda), 3, 1,
                            torch.float64, g, cuda)
    with pytest.raises(ValueError, match="power of two"):
        pipecg_bsr_fused(*args)
    with pytest.raises(ValueError, match="float32"):
        spmv_bsr(B3.indices, B3.blocks.half(), x.half())


@pytest.mark.cuda
def test_bsr_fused_solve_on_card_matches_naive_and_dia(cuda):
    from repro_torch.core.krylov import (SolverOptions, dia_to_bsr, pipecg,
                                         tridiagonal_laplacian)
    from repro_torch.kernels import ops
    A = tridiagonal_laplacian(4096, device=cuda)
    B = dia_to_bsr(A, bs=4)
    b = torch.randn(4096, generator=torch.Generator(device=cuda)
                    .manual_seed(13), device=cuda, dtype=torch.float64)
    ops.reset_launch_counts()
    fused = pipecg(B, b, options=SolverOptions(engine="fused", maxiter=60))
    counts = ops.launch_counts()
    assert counts["pipecg_bsr_fused"] == 60 and counts["spmv_bsr"] == 2
    assert counts["pipecg_spmv_fused"] == counts["spmv_dia"] == 0
    for want in (pipecg(B, b, options=SolverOptions(engine="naive",
                                                    maxiter=60)),
                 pipecg(A, b, options=SolverOptions(engine="fused",
                                                    maxiter=60))):
        torch.testing.assert_close(fused.res_history, want.res_history,
                                   rtol=1e-10, atol=0)
