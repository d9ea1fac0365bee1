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
takes powers of two).  The LM kernels sum in another order than their
plain versions' matmuls: ``flash_attention`` is held to its float32 plain
version, to 2e-5 on float32 inputs and, on bfloat16 inputs (P rounded to
bf16 on the tensor cores), to the two-part bar of
``flash_attn.bf16_error``; ``wkv_recurrent`` to 2e-5 of max |o|.
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
    return _bsr_args(dia_to_bsr(A, bs=bs), k, acc, g, cuda)


def _bsr_args(B, k, acc, g, cuda):
    B = type(B)(indices=B.indices, blocks=B.blocks.to(acc))
    x, r, u, p = (torch.randn(k, B.n, generator=g, device=cuda, dtype=acc)
                  for _ in range(4))
    a, b = (torch.rand(k, generator=g, device=cuda, dtype=acc)
            for _ in range(2))
    invd = (1.0 / B.diagonal()).contiguous()
    return B, (B.indices, B.blocks, invd, B.column_checksum(), x, r, u, p,
               a, b)


def _bsr_sweep_matches_plain(B, args, acc):
    from repro_torch.kernels.spmv_bsr import (pipecg_bsr_fused,
                                              pipecg_bsr_fused_plain,
                                              spmv_bsr_plain)
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


def _scattered(B, g):
    """``B`` under a random symmetric permutation of its block rows: most
    gathers leave the sweep's per-CTA range of block rows."""
    nbr = B.n_block_rows
    perm = torch.randperm(nbr, generator=g, device=g.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(nbr, device=g.device)
    return type(B)(indices=inv[B.indices[perm].long()].int().contiguous(),
                   blocks=B.blocks[perm].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("acc", [torch.float64, torch.float32])
@pytest.mark.parametrize("bs", [2, 4, 8])
def test_bsr_kernels_match_plain_on_card(cuda, bs, acc):
    from repro_torch.core.krylov import laplacian_2d, tridiagonal_laplacian
    from repro_torch.kernels.spmv_bsr import spmv_bsr, spmv_bsr_plain
    g = torch.Generator(device=cuda).manual_seed(11)
    for A in (tridiagonal_laplacian(4096, device=cuda),
              laplacian_2d(72, 50, device=cuda)):
        B, args = _bsr_operands(A, bs, 3, acc, g, cuda)
        x = args[4]
        for v in (x, x[0]):
            assert torch.equal(spmv_bsr(B.indices, B.blocks, v),
                               spmv_bsr_plain(B.indices, B.blocks, v))
        _bsr_sweep_matches_plain(B, args, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("acc", [torch.float64, torch.float32])
@pytest.mark.parametrize("bs", [1, 2, 4, 8, 16, 32])
def test_bsr_sweep_bit_for_bit_at_every_block_size(cuda, bs, acc):
    """The sweep's u' tile per CTA (256 / bs block rows) against the plain
    version: a block count that is not a multiple of the range, a 2-D
    Laplacian whose +-nx neighbours lie outside it, and that operator
    scattered by a random block permutation, where most gathers take the
    recompute path."""
    from repro_torch.core.krylov import (dia_to_bsr, laplacian_2d,
                                         tridiagonal_laplacian)
    g = torch.Generator(device=cuda).manual_seed(14)
    nbr = (256 // bs) * 9 + 5
    tri = dia_to_bsr(tridiagonal_laplacian(nbr * bs, device=cuda), bs=bs)
    lap = dia_to_bsr(laplacian_2d(64, 48, device=cuda), bs=bs)
    for B in (tri, lap, _scattered(lap, g)):
        for k in (1, 2):
            B2, args = _bsr_args(B, k, acc, g, cuda)
            _bsr_sweep_matches_plain(B2, args, acc)


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
    _, args = _bsr_operands(tridiagonal_laplacian(300, device=cuda), 4, 1,
                            torch.float64, g, cuda)
    u = torch.zeros(301, device=cuda, dtype=torch.float64)[1:].view(1, 300)
    with pytest.raises(ValueError, match="16-byte"):
        pipecg_bsr_fused(*args[:6], u, *args[7:])
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


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,D,dt,causal", [
    (4, 256, 64, torch.float32, True), (2, 384, 128, torch.float32, True),
    (3, 200, 64, torch.float32, True), (2, 256, 64, torch.float32, False),
    (2, 200, 64, torch.float32, False), (1, 1, 64, torch.float32, True),
    (8, 1000, 128, torch.bfloat16, True), (4, 129, 64, torch.bfloat16, False),
    (64, 2048, 128, torch.bfloat16, True), (4, 1000, 64, torch.bfloat16, True),
    (2, 1, 128, torch.bfloat16, True), (3, 1, 64, torch.bfloat16, False),
    (2, 37, 128, torch.bfloat16, True), (2, 50, 64, torch.bfloat16, False),
    (4, 1000, 128, torch.bfloat16, False)])
def test_flash_kernel_matches_plain_on_card(cuda, BH, S, D, dt, causal):
    from repro_torch.kernels.flash_attn import (bf16_error, flash_attention,
                                                flash_attention_plain)
    g = torch.Generator(device=cuda).manual_seed(20)
    q, k, v = (torch.randn(BH, S, D, generator=g, device=cuda).to(dt)
               for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    # the plain version in float32 on the same (bf16) values: the oracle
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    if dt == torch.float32:
        assert float((got - want).abs().max()) <= 2e-5
    else:
        elem, rms = bf16_error(got, want, v)
        assert elem <= 1.0 and rms <= 1.0, (elem, rms)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_wkv_kernel_matches_plain_on_card(cuda, D, dt):
    from repro_torch.kernels.wkv import wkv_recurrent, wkv_recurrent_plain
    g = torch.Generator(device=cuda).manual_seed(21)
    BH, T = 5, 300
    r, k, v = (torch.randn(BH, T, D, generator=g, device=cuda).to(dt)
               for _ in range(3))
    u = (0.3 * torch.randn(BH, D, generator=g, device=cuda)).to(dt)
    for logw in (-torch.exp(torch.randn(BH, T, D, generator=g, device=cuda)
                            - 2.0),
                 torch.full((BH, T, D), -8.0, device=cuda),
                 torch.full((BH, T, D), -1e-4, device=cuda)):
        logw = logw.to(dt)
        got = wkv_recurrent(r, k, v, logw, u)
        want = wkv_recurrent_plain(r, k, v, logw, u)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2e-5 * scale


@pytest.mark.cuda
def test_lm_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.wkv import wkv_recurrent
    q = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                        q[..., :32].contiguous())
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(64, 2, 64, device=cuda).transpose(0, 1)
        flash_attention(t, t, t)
    with pytest.raises(ValueError, match="one"):
        flash_attention(q, q[:, :32], q)
    x = torch.zeros(2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wkv_recurrent(x, x, x, x, x[:, 0])
    x = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        wkv_recurrent(x, x, x.half(), x, x[:, 0])


@pytest.mark.cuda
def test_serve_prefill_goes_through_the_flash_kernel(cuda):
    import dataclasses
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params, prefill
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), head_dim=64,
                              attn_kernel=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    out = serve(cfg, batch=2, prompt_len=100, decode_steps=4, device=cuda,
                params=params, progress=lambda s: None)
    assert out["launches"]["prefill"]["flash_attention"] == cfg.num_layers
    assert out["launches"]["decode"]["flash_attention"] == 0
    assert tuple(out["tokens"].shape) == (2, 4)
    from repro_torch.launch.serve import prompt_tokens
    plain = dataclasses.replace(cfg, attn_kernel=False)
    with torch.inference_mode():
        lp, _ = prefill(params, plain, {"tokens": prompt_tokens(
            cfg, 2, 100, cuda)})
    gap = (out["logits"].float() - lp.float()).abs()
    assert float(gap.max()) <= 0.15
