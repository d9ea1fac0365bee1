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
sweep.  ``spmv_dia_ext`` (the extended-x entry) is held bit for bit from
1 to 21 bands, with a halo wider than the bands reach and k = 3 columns,
and GMRES / PGMRES on the fused engine launch exactly one ``fused_dots``
an Arnoldi step (``fused_dots`` at their widths m = 41 and 42, rows off
16 bytes).  The row-window sweeps (all four PIPECG and p-BiCGStab entries) are
also held bit for bit from one row through a tile's edges to 1026 tiles,
with bands far beyond the shared window, at unaligned rows in bf16 and
fp8, with rows past ``n_valid`` masked; two launches must agree bit for
bit, partials included, and column j of a k = 8 launch must equal a
one-column launch.  The BSR kernels run on ``dia_to_bsr`` of the 1-D and 2-D
Laplacians at bs 2, 4 and 8 (bs 3 through the SpMV only: the sweep
takes powers of two).  The LM kernels sum in another order than their
plain versions' matmuls: ``flash_attention`` is held to its float32 plain
version, to 2e-5 on float32 inputs and, on bfloat16 inputs (P rounded to
bf16 on the tensor cores), to the two-part bar of
``flash_attn.bf16_error``; ``wkv_recurrent`` to 2e-5 of max |o|, and
so the model's chunked RWKV form from a zero state.  ``moe_ffn`` on the
card matches its CPU run to 2e-5 with the same drops, and a MoE and a
codebook + frontend config launch one flash kernel per attention layer
in prefill.  The
serve batcher on the fused sweep (k = 8): retired columns equal solo
serves bit for bit, a NaN-poisoned column and garbage in free columns
leave the live columns' bits alone, and a mid-flight admission perturbs
no in-flight column.  Sharded models on 4 gloo ranks of the card
(tests/torch_sharded_ranks.py, one spawn, smoke size, float32): the
sharded loss and gradients equal one device's, the expert route equals
the gather route at the capacity that drops nothing, every rank stores
its share of the plan on the card, and a sharded prefill launches the
flash kernel once per attention layer on every rank.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
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
from repro_torch.kernels.spmv_dia import (spmv_dia, spmv_dia_ext,
                                          spmv_dia_ext_plain, spmv_dia_plain)


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
    (torch.float64, torch.float64), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("offsets,halo,k,n", [
    ((-1, 0, 1), 1, 1, 524_288), ((-1, 0, 1), 3, 1, 1023),
    ((0,), 0, 2, 5000), ((-2, -1, 0, 1, 2), 2, 3, 70_001),
    (tuple(range(-10, 11)), 10, 1, 524_288)])
def test_spmv_dia_ext_matches_plain_on_card(cuda, acc, sto, offsets, halo,
                                            k, n):
    g = torch.Generator(device=cuda).manual_seed(n % 997 + len(offsets))
    bands = torch.randn(len(offsets), n, generator=g, device=cuda,
                        dtype=torch.float64).to(sto)
    x_ext = torch.randn(k, n + 2 * halo, generator=g, device=cuda,
                        dtype=torch.float64).to(acc)
    x_ext = x_ext[0] if k == 1 else x_ext
    before = spmv_dia_ext.launches
    got = spmv_dia_ext(offsets, bands, x_ext, halo)
    want = spmv_dia_ext_plain(offsets, bands, x_ext, halo)
    torch.cuda.synchronize()
    assert spmv_dia_ext.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_spmv_dia_ext_rejects_what_it_does_not_take(cuda):
    bands = torch.ones(3, 64, device=cuda, dtype=torch.float64)
    x = torch.ones(66, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 or float64"):
        spmv_dia_ext((-1, 0, 1), bands, x.half(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_dia_ext((-1, 0, 1), bands,
                     torch.ones(2, 66, device=cuda, dtype=torch.float64).T
                     .contiguous().T, 1)
    with pytest.raises(ValueError, match="does not cover"):
        spmv_dia_ext((-2, 0, 2), bands, x, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [41, 42])
def test_fused_dots_at_gmres_widths_off_16_bytes(cuda, dt, m):
    """GMRES's (m + 1) and PGMRES's (m + 2) rows at restart 40, V and z
    starting one word past 16 bytes and n odd: single-word loads."""
    g = torch.Generator(device=cuda).manual_seed(m)
    n = 100_003
    Vb = torch.randn(m * n + 1, generator=g, device=cuda, dtype=dt)
    zb = torch.randn(n + 1, generator=g, device=cuda, dtype=dt)
    V, z = Vb[1:].view(m, n), zb[1:]
    V[m // 2:] = 0.0      # the masked rows of an early Arnoldi step
    got = fused_dots(V, z)
    want = fused_dots_plain(V, z)
    torch.cuda.synchronize()
    tol = 1e-12 if dt == torch.float64 else 1e-5
    mags = (V * z).abs().sum(-1)
    assert bool(((got - want).abs() <= tol * mags + 1e-30).all())
    assert bool((got[m // 2:] == 0).all())
    assert torch.equal(got, fused_dots(V, z))


@pytest.mark.cuda
def test_gmres_family_on_card_launches_one_dots_a_step(cuda):
    from repro_torch.core.krylov import (SolverOptions, gmres, pgmres,
                                         tridiagonal_laplacian)
    from repro_torch.kernels import ops
    A = tridiagonal_laplacian(4096)
    b = torch.randn(4096, generator=torch.Generator(device=cuda)
                    .manual_seed(2), device=cuda, dtype=torch.float64)
    m = 40
    for solver, steps in ((gmres, m), (pgmres, m + 2)):
        ops.reset_launch_counts()
        fused = solver(A, b, restart=m,
                       options=SolverOptions(engine="fused"))
        counts = ops.launch_counts()
        assert counts["fused_dots"] == steps
        assert counts["spmv_dia"] == steps + 2
        assert sum(counts.values()) == 2 * steps + 2
        naive = solver(A, b, restart=m,
                       options=SolverOptions(engine="naive"))
        keep = naive.res_history > 1e-4 * naive.res_history[0]
        torch.testing.assert_close(fused.res_history[keep],
                                   naive.res_history[keep], rtol=1e-10,
                                   atol=0)
        scale = float(naive.x.abs().max())
        assert float((fused.x - naive.x).abs().max()) <= 1e-10 * scale


@pytest.mark.cuda
def test_inline_use_kernel_runs_the_extended_entry_on_card(cuda, tmp_path):
    """A one-rank gloo group on the card: the inline route's SpMVs go
    through ``spmv_dia_ext`` and give the plain route's numbers."""
    import torch.distributed as dist
    from repro_torch.core.krylov import (distributed_solve, pgmres,
                                         tridiagonal_laplacian)
    from repro_torch.kernels import ops
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        A = tridiagonal_laplacian(4096)
        b = torch.randn(4096, generator=torch.Generator(device=cuda)
                        .manual_seed(3), device=cuda, dtype=torch.float64)
        ops.reset_launch_counts()
        got = distributed_solve(pgmres, A, b, restart=20, use_kernel=True)
        assert ops.launch_counts()["spmv_dia_ext"] == 20 + 2 + 2
        want = distributed_solve(pgmres, A, b, restart=20)
        assert torch.equal(got.res_history, want.res_history)
        assert torch.equal(got.x, want.x)
    finally:
        dist.destroy_process_group()


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 70001, 2_097_152])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_fused_dots_one_launch_repeats_bit_for_bit(cuda, dt, n):
    """Every m through the one-launch finish (groups of 8 columns, ragged
    n on single-word loads, 2M on 16-byte loads): within the bars of the
    plain version, a second launch bit for bit, the ticket back at 0."""
    from repro_torch.kernels.pipecg_spmv_fused import tickets
    g = torch.Generator(device=cuda).manual_seed(n % 1000 + 7)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    for m in (1, 3, 8, 9, 30, 41):
        V = torch.randn(m, n, generator=g, device=cuda, dtype=dt)
        z = torch.randn(n, generator=g, device=cuda, dtype=dt)
        before = fused_dots.launches
        got = fused_dots(V, z)
        again = fused_dots(V, z)
        want = fused_dots_plain(V, z)
        torch.cuda.synchronize()
        assert fused_dots.launches == before + 2
        mags = (V * z).abs().sum(-1)
        assert bool(((got - want).abs() <= tol * mags + 1e-30).all()), m
        assert torch.equal(got, again), m
        assert int(tickets(cuda, 1)[0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_fused_dots_takes_unaligned_rows(cuda, dt):
    """V and z that do not start on 16 bytes take single-word loads."""
    g = torch.Generator(device=cuda).manual_seed(8)
    m, n = 5, 4096
    Vb = torch.randn(m * n + 1, generator=g, device=cuda, dtype=dt)
    zb = torch.randn(n + 1, generator=g, device=cuda, dtype=dt)
    V, z = Vb[1:].view(m, n), zb[1:]
    got = fused_dots(V, z)
    want = fused_dots_plain(V, z)
    torch.cuda.synchronize()
    tol = 1e-12 if dt == torch.float64 else 1e-5
    assert bool(((got - want).abs() <= tol * (V * z).abs().sum(-1)).all())
    assert torch.equal(got, fused_dots(V, z))


@pytest.mark.cuda
def test_fused_dots_runs_one_kernel(cuda):
    """One kernel a call: the finish runs in the launch, with no second
    reduction kernel."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(9)
    V = torch.randn(3, 524_288, generator=g, device=cuda,
                    dtype=torch.float64)
    z = torch.randn(524_288, generator=g, device=cuda, dtype=torch.float64)
    fused_dots(V, z)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_dots(V, z)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA" and "Memcpy" not in e.name
             and "Memset" not in e.name]
    assert len(names) == 1 and "fused_dots_kernel" in names[0], names


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
    the tile): the register path at l = 2 and 4 on ex23, the runtime
    loops elsewhere, two-batch windows for laplacian_2d at l = 8
    (tests/test_torch_chain_plan.py)."""
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


def _chain_case(A, l, acc, sto, g, halo=False, q=1):
    """(entry, its plain version, arguments) of a chain sweep on ``A``:
    the one-device sweep, or rank ``q`` of 4 with real strips."""
    from repro_torch.core.krylov import dia_inf_norm
    from repro_torch.kernels.pipecg_spmv_fused import _halo
    p, r = (torch.randn(A.n, generator=g, device=g.device,
                        dtype=torch.float64).to(sto) for _ in range(2))
    theta = dia_inf_norm(A)
    if not halo:
        return (ghost_chain_fused, ghost_chain_fused_plain,
                (A.offsets, A.bands.to(sto), p, r, theta, l))
    H, n = l * _halo(A.offsets), A.n
    lo, hi = q * n // 4, (q + 1) * n // 4
    pad = torch.nn.functional.pad
    bands = pad(A.bands, (H, H))[:, lo:hi + 2 * H].to(sto).contiguous()
    strips = []
    for v in (p, r):
        wide = pad(v, (H, H))
        strips += [wide[lo:lo + H].contiguous(),
                   wide[hi + H:hi + 2 * H].contiguous()]
    return (ghost_chain_halo, ghost_chain_halo_plain,
            (A.offsets, bands, p[lo:hi].contiguous(), r[lo:hi].contiguous(),
             *strips, theta, l))


def _chain_matches(fn, plain, args, acc):
    got, again = fn(*args, accum_dtype=acc), fn(*args, accum_dtype=acc)
    want = plain(*args, accum_dtype=acc)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    wide = plain(*(t.to(acc) if torch.is_tensor(t) and t.is_floating_point()
                   and t.dim() else t for t in args))[0]
    rel = _chain_gram_rel(got[1], want[1], wide)
    assert rel <= (1e-10 if acc == torch.float64 else 1e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("l", [2, 4, 8])
@pytest.mark.parametrize("acc,sto", [
    (torch.float64, torch.float64), (torch.float32, torch.bfloat16)])
def test_ghost_chain_gram_repeats_bit_for_bit(cuda, l, halo, acc, sto):
    """Two launches give the same chain and Gram bit for bit (the
    in-launch finish sums in one order, with no float atomics), one
    device and rank 1 of 4, l = 4 and 8 with Grams of 45 and 153 entries
    (three and eleven pair groups, wider than finish_rows' 32 columns)."""
    from repro_torch.core.krylov import tridiagonal_laplacian
    g = torch.Generator(device=cuda).manual_seed(30 + l)
    A = tridiagonal_laplacian(300_001, device=cuda)
    _chain_matches(*_chain_case(A, l, acc, sto, g, halo), acc)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [2, 4])
@pytest.mark.parametrize("tiles", ["1", "32", "32+1", "1024+ragged",
                                   "1025+ragged"])
def test_ghost_chain_across_finish_groups(cuda, l, tiles):
    """n on both sides of a finish group (32 CTAs) and past 1024 CTAs:
    one group, two groups of which the last has one CTA, 33 groups."""
    from repro_torch.core.krylov import tridiagonal_laplacian
    from repro_torch.kernels.pipecg_spmv_fused import chain_plan
    tile = chain_plan(l, 2 * l + 1, 8)[0]
    n = {"1": tile, "32": 32 * tile, "32+1": 32 * tile + 1,
         "1024+ragged": 1023 * tile + 5,
         "1025+ragged": 1024 * tile + 7}[tiles]
    g = torch.Generator(device=cuda).manual_seed(40)
    A = tridiagonal_laplacian(n, device=cuda)
    _chain_matches(*_chain_case(A, l, torch.float64, torch.float64, g),
                   torch.float64)


@pytest.mark.cuda
def test_ghost_chain_halo_after_fused_on_one_stream(cuda):
    """A one-device launch, a rank launch, another one-device launch and
    a rank launch at l = 4 queued on one stream with no sync between: the
    tickets are back at zero after each, so every Gram is right."""
    from repro_torch.core.krylov import tridiagonal_laplacian
    g = torch.Generator(device=cuda).manual_seed(41)
    A = tridiagonal_laplacian(700_001, device=cuda)
    cases = [_chain_case(A, l, torch.float64, torch.float64, g, halo, q)
             for l, halo, q in ((2, False, 1), (2, True, 1), (4, False, 1),
                                (4, True, 3))]
    got = [fn(*args) for fn, _, args in cases]
    for (fn, plain, args), (C, G) in zip(cases, got):
        want = plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(C, want[0])
        assert _chain_gram_rel(G, want[1], want[0]) <= 1e-10


@pytest.mark.cuda
def test_ghost_chain_runs_the_global_workspace(cuda):
    """laplacian_2d(1448, 5) at l = 4 in float64: the links do not fit
    shared memory, so they live in the global scratch."""
    from repro_torch.core.krylov import laplacian_2d
    from repro_torch.kernels.pipecg_spmv_fused import chain_plan
    A = laplacian_2d(1448, 5, device=cuda)
    assert chain_plan(4 * 1448, 9, 8)[2] is False
    g = torch.Generator(device=cuda).manual_seed(42)
    _chain_matches(*_chain_case(A, 4, torch.float64, torch.float64, g),
                   torch.float64)


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
@pytest.mark.parametrize("T", [1, 31, 33, 300])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_wkv_kernel_ragged_chunks_repeat_bit_for_bit(cuda, dt, D, T):
    """Ragged last chunks (T around the 32- and 16-step stages), one head
    and 257 heads, the three decay settings: within 2e-5 of max |o|,
    finite, and a second launch bit for bit."""
    from repro_torch.kernels.wkv import wkv_recurrent, wkv_recurrent_plain
    g = torch.Generator(device=cuda).manual_seed(T + D)
    for BH in (1, 257):
        r, k, v = (torch.randn(BH, T, D, generator=g, device=cuda).to(dt)
                   for _ in range(3))
        u = (0.3 * torch.randn(BH, D, generator=g, device=cuda)).to(dt)
        for logw in (-torch.exp(torch.randn(BH, T, D, generator=g,
                                            device=cuda) - 2.0),
                     torch.full((BH, T, D), -8.0, device=cuda),
                     torch.full((BH, T, D), -1e-4, device=cuda)):
            logw = logw.to(dt)
            got = wkv_recurrent(r, k, v, logw, u)
            again = wkv_recurrent(r, k, v, logw, u)
            want = wkv_recurrent_plain(r, k, v, logw, u)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all())
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 2e-5 * scale, (BH,)
            assert torch.equal(got, again)


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


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [-2.0, -8.0])
def test_rwkv_chunked_form_matches_wkv_kernel_on_card(cuda, decay):
    """The model's chunked RWKV form from a zero state against the
    ``wkv_recurrent`` kernel on (B*H, S, D) contiguous copies of the same
    inputs: within 2e-5 of max |o|."""
    from repro_torch.kernels.wkv import wkv_recurrent
    from repro_torch.models.recurrent import _wkv_chunked
    g = torch.Generator(device=cuda).manual_seed(22)
    B, S, H, D = 2, 256, 4, 64
    r, k, v = (torch.randn(B, S, H, D, generator=g, device=cuda)
               for _ in range(3))
    logw = -torch.exp(torch.randn(B, S, H, D, generator=g, device=cuda)
                      + decay)
    u = 0.5 * torch.randn(H, D, generator=g, device=cuda)
    o, _ = _wkv_chunked(r, k, v, logw, u,
                        torch.zeros(B, H, D, D, device=cuda))

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()

    before = wkv_recurrent.launches
    want = wkv_recurrent(fold(r), fold(k), fold(v), fold(logw),
                         u.repeat(B, 1))
    assert wkv_recurrent.launches == before + 1
    got = fold(o)
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_moe_ffn_on_card_matches_its_cpu_run(cuda):
    """olmoe's smoke MoE in float32, with a capacity that drops tokens and
    at the decode case T = B: the card's output and aux terms against the
    CPU run on the same weights, the same drops, and bit-equal repeats."""
    import dataclasses
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models.moe import init_moe, moe_ffn
    base = dataclasses.replace(smoke_config("olmoe-1b-7b"), dtype="float32")
    for cf, S in ((0.5, 32), (2.0, 1)):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        p = init_moe(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
        x = torch.randn(4, S, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
        want, waux = moe_ffn(p, cfg, x, torch.float32)
        p.to(cuda)
        got, gaux = moe_ffn(p, cfg, x.to(cuda), torch.float32)
        again, _ = moe_ffn(p, cfg, x.to(cuda), torch.float32)
        assert torch.equal(got, again)
        assert float((got.cpu() - want).abs().max()) <= 2e-5
        for key in ("moe_aux", "moe_z"):
            assert abs(float(gaux[key]) - float(waux[key])) <= 2e-5
        assert int(gaux["moe_dropped"]) == int(waux["moe_dropped"])
        assert (int(waux["moe_dropped"]) > 0) == (cf == 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "musicgen-medium"])
def test_family_prefill_launches_one_flash_per_attention_layer(cuda, arch):
    """A MoE and a codebook + frontend config at smoke width (head dim
    64 for the kernel, float32 compute: in bf16 the two routes' rounding
    can turn a near-tied top-2 choice of 4 experts, which moves a
    token's logits by O(1)): one flash launch per attention layer in
    prefill, none in decode, and the prefill logits within 1e-3 of the
    dense route's on the same weights and prompt."""
    import dataclasses
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.serve import serve, serve_batch
    from repro_torch.models import init_params, prefill
    cfg = dataclasses.replace(smoke_config(arch), head_dim=64,
                              attn_kernel=True, dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    out = serve(cfg, batch=2, prompt_len=100, decode_steps=4, device=cuda,
                params=params, progress=lambda s: None)
    assert out["launches"]["prefill"]["flash_attention"] == cfg.num_layers
    assert out["launches"]["decode"]["flash_attention"] == 0
    ncb = cfg.num_codebooks
    assert tuple(out["tokens"].shape) == (2, 4) + ((ncb,) if ncb > 1
                                                   else ())
    plain = dataclasses.replace(cfg, attn_kernel=False)
    with torch.inference_mode():
        lp, _ = prefill(params, plain, serve_batch(cfg, 2, 100, cuda))
    got = out["logits"] if ncb > 1 else (out["logits"],)
    lp = lp if ncb > 1 else (lp,)
    for a, b in zip(got, lp):
        assert float((a - b).abs().max()) <= 1e-3


# -- the row-window sweeps (PIPECG and p-BiCGStab, both entries) -------------

def _sweep_tile(entry, offsets):
    import repro_torch.kernels.pipebicgstab_fused as bicg
    import repro_torch.kernels.pipecg_spmv_fused as pcg
    mod = pcg if entry.startswith("pipecg") else bicg
    return mod.sweep_plan(offsets, 8)[0]


def _pipecg_operands(offsets, n, k, acc, sto, g, cuda, halo=False,
                     bands=None):
    """Random PIPECG sweep operands (random bands unless given); with
    ``halo`` the operator rows [-h, n + h) and (k, 2h) strips."""
    h = max(abs(o) for o in offsets)
    ext = h if halo else 0

    def rnd(*shape, dt=acc):
        return torch.randn(*shape, generator=g, device=cuda,
                           dtype=torch.float64).to(dt)

    if bands is None:
        bands = rnd(len(offsets), n + 2 * ext, dt=torch.float64)
        if 0 in offsets:
            bands[offsets.index(0)] = bands[offsets.index(0)].abs() + 2.0
    invd = (1.0 / bands[offsets.index(0)]).to(sto) if 0 in offsets else \
        rnd(n + 2 * ext, dt=sto)
    csum = dia_column_checksum(offsets, bands.to(sto).double(),
                               halo=ext).to(sto)
    bands = bands.to(sto)
    x = rnd(k, n)
    r, u, p = (rnd(k, n, dt=sto) for _ in range(3))
    a = torch.rand(k, generator=g, device=cuda, dtype=acc)
    b = torch.rand(k, generator=g, device=cuda, dtype=acc)
    if halo:
        strips = [rnd(k, 2 * h, dt=sto) for _ in range(4)]
        return (offsets, bands, invd, csum, x, r, u, p, *strips, a, b)
    return (offsets, bands, invd, csum, x, r, u, p, a, b)


def _bicg_operands(offsets, n, acc, sto, g, cuda, halo=False, bands=None):
    """Random p-BiCGStab sweep operands; with ``halo`` the operator rows
    [-h, n + h) and (2h,) strips of w, t and c."""
    h = max(abs(o) for o in offsets)
    ext = h if halo else 0

    def rnd(*shape, dt=acc):
        return torch.randn(*shape, generator=g, device=cuda,
                           dtype=torch.float64).to(dt)

    if bands is None:
        bands = rnd(len(offsets), n + 2 * ext, dt=torch.float64)
    csum = dia_column_checksum(offsets, bands, halo=ext).to(acc)
    bands = bands.to(sto)
    x = rnd(n)
    chains = [rnd(n, dt=sto) for _ in range(7)]
    sc = [torch.rand((), generator=g, device=cuda, dtype=acc)
          for _ in range(3)]
    if halo:
        strips = [rnd(2 * h, dt=sto) for _ in range(6)]
        return (offsets, bands, csum, x, *chains, *strips, *sc)
    return (offsets, bands, csum, x, *chains, *sc)


_ENTRIES = {
    "pipecg_spmv_fused": (pipecg_spmv_fused, pipecg_spmv_fused_plain, False),
    "pipecg_spmv_halo": (pipecg_spmv_halo, pipecg_spmv_halo_plain, True),
    "pipebicgstab_fused": (pipebicgstab_fused, pipebicgstab_fused_plain,
                           False),
    "pipebicgstab_halo": (pipebicgstab_halo, pipebicgstab_halo_plain, True),
}


def _entry_args(entry, offsets, n, acc, sto, g, cuda, k=2, bands=None):
    _, _, halo = _ENTRIES[entry]
    if entry.startswith("pipecg"):
        return _pipecg_operands(offsets, n, k, acc, sto, g, cuda, halo,
                                bands)
    return _bicg_operands(offsets, n, acc, sto, g, cuda, halo, bands)


def _partial_rel(got, want):
    """The partials' gap, relative to their magnitude (at least 1)."""
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def _sweep_bit_for_bit(entry, args, acc):
    """Vectors torch.equal to the plain version, partials at the gates,
    and a second launch bit-identical to the first, partials included."""
    fn, plain, _ = _ENTRIES[entry]
    got, again = fn(*args), fn(*args)
    nvec = 4 if entry.startswith("pipecg") else 7
    fp8 = getattr(torch, "float8_e4m3fn", None)
    if fp8 is not None and args[1].dtype == fp8:
        # the plain version widens every fp8 operand first and narrows
        # only its stores: run it on the widened operands (exact), then
        # narrow, so no float8 op beyond the casts is needed
        want = list(plain(*(t.to(acc) if torch.is_tensor(t)
                            and t.dtype == fp8 else t for t in args)))
        want = [w.to(gv.dtype) for w, gv in zip(want, got)]
    else:
        want = plain(*args)
    torch.cuda.synchronize()
    for i, (gv, wv) in enumerate(zip(got[:nvec], want[:nvec])):
        assert torch.equal(gv, wv), f"{entry} out{i}"
    for gv, av in zip(got, again):
        assert torch.equal(gv, av), f"{entry} differs between launches"
    tol = 1e-10 if acc == torch.float64 else 1e-3
    assert _partial_rel(got[nvec], want[nvec]) <= tol
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("size", ["1", "2", "tile-1", "tile", "tile+1",
                                  "3tile+ragged", "1025tiles+ragged"])
def test_window_sweeps_across_tile_edges(cuda, entry, size):
    """n from one row through a tile's edges to several tiles and a
    ragged end (1026 CTAs: the two-level finish, its last group of two),
    on a 4-band operator with a random extension."""
    offsets = (-3, -1, 0, 2)
    tile = _sweep_tile(entry, offsets)
    n = {"1": 1, "2": 2, "tile-1": tile - 1, "tile": tile,
         "tile+1": tile + 1, "3tile+ragged": 3 * tile + 17,
         "1025tiles+ragged": 1025 * tile + 5}[size]
    g = torch.Generator(device=cuda).manual_seed(11)
    args = _entry_args(entry, offsets, n, torch.float64, torch.float64, g,
                       cuda)
    _sweep_bit_for_bit(entry, args, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("offsets", [(-3000, -1, 0, 1, 3000),
                                     (-1100, -1, 0, 1, 1100)])
def test_window_sweeps_reach_past_the_window(cuda, entry, offsets):
    """Bands far beyond a tile (their own window clusters): random
    bands, and laplacian_2d(1100, 7)'s +-nx bands for the second."""
    from repro_torch.core.krylov import laplacian_2d
    g = torch.Generator(device=cuda).manual_seed(12)
    bands = None
    n = 7700
    if offsets[0] == -1100:
        A = laplacian_2d(1100, 7, device=cuda)
        assert tuple(A.offsets) == offsets
        n = A.n
        if not _ENTRIES[entry][2]:
            bands = A.bands
    args = _entry_args(entry, offsets, n, torch.float64, torch.float64, g,
                       cuda, bands=bands)
    _sweep_bit_for_bit(entry, args, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_window_sweeps_take_21_bands(cuda, entry):
    """glen_law_band's 21 bands through all four entries."""
    A = _glen(6001, cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    bands = None if _ENTRIES[entry][2] else A.bands
    args = _entry_args(entry, tuple(A.offsets), A.n, torch.float64,
                       torch.float64, g, cuda, bands=bands)
    _sweep_bit_for_bit(entry, args, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("sto", ["bfloat16", "float8_e4m3fn"])
def test_window_sweeps_at_unaligned_rows(cuda, entry, sto):
    """Odd n, k = 8 (PIPECG) and narrow storage: no row of a right-hand
    side starts on 16 bytes."""
    sto = getattr(torch, sto)
    g = torch.Generator(device=cuda).manual_seed(14)
    args = _entry_args(entry, (-1, 0, 1), 4097, torch.float32, sto, g,
                       cuda, k=8)
    _sweep_bit_for_bit(entry, args, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["pipecg_spmv_fused", "pipecg_spmv_halo"])
@pytest.mark.parametrize("acc,sto", [(torch.float64, torch.float64),
                                     (torch.float32, torch.bfloat16)])
def test_window_sweep_columns_do_not_depend_on_k(cuda, entry, acc, sto):
    """Column j of a k = 8 launch equals a k = 1 launch on column j bit
    for bit, partials included."""
    fn, _, _ = _ENTRIES[entry]
    g = torch.Generator(device=cuda).manual_seed(15)
    args = _entry_args(entry, (-3, -1, 0, 2), 5001, acc, sto, g, cuda, k=8)
    whole = fn(*args)
    for j in range(8):  # offsets, bands, diag^-1, csum shared; the rest (8, .)
        one = fn(*args[:4], *(t[j:j + 1] for t in args[4:]))
        for i, (gv, wv) in enumerate(zip(one, whole)):
            assert torch.equal(gv[0], wv[j]), f"column {j} out{i}"


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["pipecg_spmv_halo", "pipebicgstab_halo"])
def test_window_sweeps_mask_rows_past_n_valid(cuda, entry):
    """Rows >= n_valid stay out of the partials (the kernel's mask; the
    entries pass n_valid = n): the plain sweep's terms over the rows
    [0, n_valid), the vectors unchanged."""
    import repro_torch.kernels.pipebicgstab_fused as bicg
    import repro_torch.kernels.pipecg_spmv_fused as pcg
    g = torch.Generator(device=cuda).manual_seed(16)
    offsets = (-3, -1, 0, 2)
    n, n_valid, h = 3000, 2500, 3
    args = _entry_args(entry, offsets, n, torch.float64, torch.float64, g,
                       cuda)
    full = _ENTRIES[entry][0](*args)
    keep = slice(2 * h, 2 * h + n_valid)

    def pad(v, w):
        z = torch.zeros(v.shape[:-1] + (w,), dtype=v.dtype, device=v.device)
        return torch.cat([z, v, z], dim=-1)

    if entry == "pipecg_spmv_halo":
        (_, bands, invd, csum, x, r, u, p, ul, uh, pl, ph, a, b) = args
        got = pcg._launch(entry, offsets, bands, invd, csum, x, r, u, p, a,
                          b, oext=h, strips=(ul, uh, pl, ph), n_valid=n_valid)
        want = pcg._sweep_plain(
            offsets, pad(bands, h), pad(invd, h), pad(csum, 2 * h),
            pad(x, 2 * h), pad(r, 2 * h), torch.cat([ul, u, uh], -1),
            torch.cat([pl, p, ph], -1), a, b, rows=keep)[4]
        nvec = 4
    else:
        (_, bands, csum, x, r, w, t, pa, a_, c, rh, wl, wh, tl, th, cl, ch,
         al, be, om) = args
        got = bicg._launch(entry, offsets, bands, csum, x, r, w, t, pa, a_,
                           c, rh, al, be, om, oext=h,
                           strips=(wl, wh, tl, th, cl, ch), n_valid=n_valid)
        want = bicg._sweep_plain(
            offsets, pad(bands, h), pad(csum, 2 * h), pad(x, 2 * h),
            pad(r, 2 * h), torch.cat([wl, w, wh]), torch.cat([tl, t, th]),
            pad(pa, 2 * h), pad(a_, 2 * h), torch.cat([cl, c, ch]),
            pad(rh, 2 * h), al, be, om, rows=keep)[7]
        nvec = 7
    torch.cuda.synchronize()
    for gv, fv in zip(got[:nvec], full[:nvec]):
        assert torch.equal(gv, fv)
    assert _partial_rel(got[nvec], want) <= 1e-10
    assert not torch.allclose(got[nvec], full[nvec])


# -- the serve batcher on the fused sweep (kernel #2 at k = 8) ---------------

def _serve_on_card(reqs, k=8):
    import dataclasses
    from repro_torch.serve import SolverServer
    srv = SolverServer(k_slots=k, step_block=8)   # engine "fused"
    srv.warmup(reqs[0])
    srv.submit_all([dataclasses.replace(r) for r in reqs])
    return srv, srv.run()


@pytest.mark.cuda
def test_serve_retired_columns_equal_solo_serves_on_card(cuda):
    import numpy as np
    from repro_torch.core.krylov import tridiagonal_laplacian
    from repro_torch.serve import synthetic_requests
    A = tridiagonal_laplacian(4096)
    reqs = synthetic_requests(A, 12, tol=1e-8, maxiter=600, modes=(16, 64),
                              seed=0)
    srv, stats = _serve_on_card(reqs)
    assert stats.drained and stats.n_converged == 12
    rc = srv.run_counts
    assert rc["launches"]["pipecg_spmv_fused"] == 8 * rc["blocks"]
    assert rc["launches"]["spmv_dia"] == 2 * rc["admissions"]
    assert sum(rc["launches"].values()) == \
        8 * rc["blocks"] + 2 * rc["admissions"]
    batched = {r.rid: r for r in srv.records}
    for req in reqs[:4]:
        solo, _ = _serve_on_card([req])
        got, want = solo.records[0], batched[req.rid]
        assert got.iters == want.iters
        assert np.array_equal(got.x, want.x)


@pytest.mark.cuda
def test_serve_nan_and_free_garbage_leave_live_columns_alone_on_card(cuda):
    from repro_torch.core.krylov import tridiagonal_laplacian
    from repro_torch.kernels import ops
    from repro_torch.serve import ContinuousBatcher, synthetic_requests
    A = tridiagonal_laplacian(4096)
    reqs = synthetic_requests(A, 3, tol=1e-8, maxiter=600, modes=(16, 64),
                              seed=1)
    ref, hit = ContinuousBatcher(A, 8), ContinuousBatcher(A, 8)
    for bt in (ref, hit):
        for slot, req in enumerate(reqs):
            bt.admit(slot, req)
    g = torch.Generator(device=cuda).manual_seed(3)
    for v in hit.state["vecs"].values():   # frozen garbage, free columns
        v[3:] = 1e300 * torch.randn(v[3:].shape, generator=g, device=cuda,
                                    dtype=v.dtype)
    for key in ("gamma", "delta", "alpha_prev"):
        hit.state[key][3:] = float("nan")
    hit.poison(2)                          # a killed live column
    before = ops.launch_counts()["pipecg_spmv_fused"]
    for _ in range(4):
        ref.step()
        hit.step()
    assert ops.launch_counts()["pipecg_spmv_fused"] - before == 2 * 4 * 8
    for key, v in ref.state["vecs"].items():
        assert torch.equal(hit.state["vecs"][key][:2], v[:2]), key
        assert not bool(torch.isfinite(hit.state["vecs"][key][2]).any())
    for key in ("gamma", "delta", "iters", "done"):
        assert torch.equal(hit.state[key][:2], ref.state[key][:2]), key


@pytest.mark.cuda
def test_serve_admission_never_perturbs_in_flight_columns_on_card(cuda):
    from repro_torch.core.krylov import tridiagonal_laplacian
    from repro_torch.serve import ContinuousBatcher, synthetic_requests
    A = tridiagonal_laplacian(4096)
    reqs = synthetic_requests(A, 2, tol=1e-8, maxiter=600, modes=(16, 64),
                              seed=2)
    solo, both = ContinuousBatcher(A, 8), ContinuousBatcher(A, 8)
    solo.admit(0, reqs[0])
    both.admit(0, reqs[0])
    solo.step()
    both.step()
    both.admit(5, reqs[1])      # mid-flight admission into a free column
    for _ in range(3):
        solo.step()
        both.step()
    for key, v in solo.state["vecs"].items():
        assert torch.equal(both.state["vecs"][key][0], v[0]), key


# -- the block autotuner (kernels/autotune.py) --------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_autotuner_probe_picks_a_feasible_tile_bit_for_bit(cuda, entry):
    """``best_block`` with a CUDA-event probe over a sweep's tile caps
    returns one of them, and the sweep launched at it equals its plain
    version bit for bit (partials at the gates)."""
    from repro_torch.kernels import autotune
    offsets, n = (-1, 0, 1), 1 << 16
    sweep = "pipecg" if entry.startswith("pipecg") else "pipebicgstab"
    fn, plain, _ = _ENTRIES[entry]
    g = torch.Generator(device=cuda).manual_seed(21)
    args = _entry_args(entry, offsets, n, torch.float64, torch.float64, g,
                       cuda)
    autotune.clear_cache()
    cap = autotune.sweep_tile_cap(
        sweep, offsets, n, torch.float64, device=cuda, reps=3,
        probe=lambda c: (lambda: fn(*args, max_tile=c)))
    key = autotune.sweep_key(sweep, offsets, n, torch.float64, device=cuda)
    assert cap in autotune.sweep_candidates(sweep)
    assert [b for _, b in autotune.scores(key)] == list(
        autotune.sweep_candidates(sweep))
    assert all(ms > 0 for ms, _ in autotune.scores(key))
    _sweep_bit_for_bit(entry, args, torch.float64)   # the default cap
    got = fn(*args, max_tile=cap)
    want = plain(*args)
    nvec = 4 if sweep == "pipecg" else 7
    for gv, wv in zip(got[:nvec], want[:nvec]):
        assert torch.equal(gv, wv)
    assert _partial_rel(got[nvec], want[nvec]) <= 1e-10
    autotune.clear_cache()


@pytest.mark.cuda
def test_warm_serve_on_card_adds_no_autotune_miss(cuda):
    """The reference's warm-reuse pin on the card: the first server's step
    builds the sweep's plan and looks its tile cap up; a second server
    over a same-shape operator with other coefficients adds no miss."""
    from repro_torch.core.krylov import tridiagonal_laplacian
    from repro_torch.core.krylov.operators import DiaMatrix
    from repro_torch.kernels import autotune
    from repro_torch.serve import SolverServer, synthetic_requests
    from repro_torch.serve.batcher import clear_compile_cache

    def serve(A, seed):
        srv = SolverServer(k_slots=2, step_block=8)   # engine "fused"
        srv.submit_all(synthetic_requests(A, 1, tol=1e-8, maxiter=200,
                                          modes=(4, 16), seed=seed))
        return srv.run()
    clear_compile_cache()
    autotune.clear_cache()
    n = 94                       # a shape no other test of this file plans
    A = tridiagonal_laplacian(n, device=cuda)
    before = pipecg_spmv_fused.launches
    assert serve(A, 3).n_converged == 1
    assert pipecg_spmv_fused.launches > before
    cold = autotune.cache_stats()
    assert cold["misses"] >= 1
    A2 = DiaMatrix(offsets=A.offsets, bands=A.bands * 1.5)
    assert serve(A2, 4).n_converged == 1
    assert autotune.cache_stats()["misses"] == cold["misses"]
    clear_compile_cache()
    autotune.clear_cache()


# -- training: no kernel output without a graph, the train step, restart --

GUARDED = ("spmv_dia", "spmv_dia_ext", "pipecg_spmv_fused",
           "pipecg_spmv_halo", "pipecg_fused", "fused_dots",
           "pipebicgstab_fused", "pipebicgstab_halo", "ghost_chain_fused",
           "ghost_chain_halo", "spmv_bsr", "pipecg_bsr_fused",
           "flash_attention", "wkv_recurrent")


def _kernel_calls(dev):
    """One small call of every kernel wrapper: {name: (fn, args)}; the
    first floating tensor of each ``args`` is the one made to require
    grad.  float64 solver operands, float32 LM ones."""
    from repro_torch.core.krylov import dia_to_bsr, tridiagonal_laplacian
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(21)

    def rnd(*shape, dt=torch.float64):
        return torch.randn(*shape, generator=g, device=dev, dtype=dt)

    n, h, l = 512, 1, 2
    A = tridiagonal_laplacian(n, device=dev)
    off, bands = A.offsets, A.bands
    diag = bands[off.index(0)]
    ext = torch.nn.functional.pad(bands, (h, h))
    ext_l = torch.nn.functional.pad(bands, (l * h, l * h))
    invd, invd_ext = 1.0 / diag, 1.0 / ext[off.index(0)].clamp(min=1.0)
    csum = dia_column_checksum(off, bands)
    csum_ext = dia_column_checksum(off, ext, halo=h)
    x, r, u, p = (rnd(1, n) for _ in range(4))
    a, b = rnd(1).abs(), rnd(1).abs()
    strips = [rnd(1, 2 * h) for _ in range(4)]
    vec = [rnd(n) for _ in range(8)]
    s3 = [rnd(()).abs() for _ in range(3)]
    B = dia_to_bsr(A, bs=4)
    bsr_vecs = [rnd(1, n) for _ in range(4)]
    q, k, v = (rnd(2, 64, 64, dt=torch.float32) for _ in range(3))
    wk = [rnd(2, 16, 16, dt=torch.float32) for _ in range(3)]
    logw = -torch.rand(2, 16, 16, generator=g, device=dev)
    return {
        "spmv_dia": (ops.KERNELS["spmv_dia"], (off, bands, vec[0])),
        "spmv_dia_ext": (ops.KERNELS["spmv_dia_ext"],
                         (off, bands, rnd(n + 2 * h), h)),
        "pipecg_spmv_fused": (ops.KERNELS["pipecg_spmv_fused"],
                              (off, bands, invd, csum, x, r, u, p, a, b)),
        "pipecg_spmv_halo": (ops.KERNELS["pipecg_spmv_halo"],
                             (off, ext, invd_ext, csum_ext, x, r, u, p,
                              *strips, a, b)),
        "pipecg_fused": (ops.KERNELS["pipecg_fused"],
                         tuple(rnd(1, n) for _ in range(10)) + (a, b)),
        "fused_dots": (ops.KERNELS["fused_dots"], (rnd(3, n), vec[0])),
        "pipebicgstab_fused": (ops.KERNELS["pipebicgstab_fused"],
                               (off, bands, csum, *vec, *s3)),
        "pipebicgstab_halo": (ops.KERNELS["pipebicgstab_halo"],
                              (off, ext, csum_ext, *vec,
                               *(rnd(2 * h) for _ in range(6)), *s3)),
        "ghost_chain_fused": (ops.KERNELS["ghost_chain_fused"],
                              (off, bands, vec[0], vec[1], 2.9, l)),
        "ghost_chain_halo": (ops.KERNELS["ghost_chain_halo"],
                             (off, ext_l, vec[0], vec[1],
                              *(rnd(l * h) for _ in range(4)), 2.9, l)),
        "spmv_bsr": (ops.KERNELS["spmv_bsr"],
                     (B.indices, B.blocks, vec[0])),
        "pipecg_bsr_fused": (ops.KERNELS["pipecg_bsr_fused"],
                             (B.indices, B.blocks,
                              (1.0 / B.diagonal()).contiguous(),
                              B.column_checksum(), *bsr_vecs, a, b)),
        "flash_attention": (ops.KERNELS["flash_attention"], (q, k, v, True)),
        "wkv_recurrent": (ops.KERNELS["wkv_recurrent"],
                          (*wk, logw, rnd(2, 16, dt=torch.float32))),
    }


def _with_grad(args):
    """args with its first floating tensor replaced by a leaf that
    requires grad."""
    out, done = [], False
    for t in args:
        if not done and torch.is_tensor(t) and t.is_floating_point():
            t = t.detach().clone().requires_grad_(True)
            done = True
        out.append(t)
    assert done
    return tuple(out)


def test_kernel_wrappers_stay_differentiable_on_the_cpu():
    """CPU tensors take the plain versions, which autograd records."""
    calls = _kernel_calls(torch.device("cpu"))
    assert set(calls) == set(GUARDED)
    for name, (fn, args) in calls.items():
        out = fn(*_with_grad(args))
        outs = out if isinstance(out, tuple) else (out,)
        assert any(o.requires_grad for o in outs), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", GUARDED)
def test_kernel_wrapper_raises_under_autograd_on_card(cuda, name):
    """A CUDA kernel's output would carry no gradient: the wrapper raises
    when autograd records an input, and launches under inference_mode
    and no_grad."""
    from repro_torch.kernels import ops
    fn, args = _kernel_calls(cuda)[name]
    before = ops.launch_counts()[name]
    with torch.inference_mode():
        fn(*args)
    with torch.no_grad():
        fn(*_with_grad(args))
    assert ops.launch_counts()[name] == before + 2
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*_with_grad(args))
    assert ops.launch_counts()[name] == before + 2


def _moments_state(cfg, tcfg, device):
    """``build_state`` with moments drawn at 1e-3 (v bounded away from
    AdamW's eps, so the update is well conditioned), step 3 and a carried
    norm of 2."""
    from repro_torch.launch.train import build_state
    state = build_state(cfg, tcfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    for key, m in state["opt"]["m"].items():
        m.copy_(1e-3 * torch.randn(m.shape, generator=g))
        state["opt"]["v"][key].copy_(
            1e-6 * (0.5 + torch.rand(m.shape, generator=g)))
    state["step"].fill_(3)
    state["prev_gnorm"].fill_(2.0)
    state["params"].to(device)
    return {"params": state["params"],
            "opt": {k: {n: t.to(device) for n, t in d.items()}
                    for k, d in state["opt"].items()},
            "step": state["step"].to(device),
            "prev_gnorm": state["prev_gnorm"].to(device)}


def _bar_ok(got, want, leaf_rtol, floor):
    top = max(float(w.abs().max()) for w in want.values())
    return all(float((got[k].cpu() - w).abs().max())
               <= leaf_rtol * float(w.abs().max()) + floor * top
               for k, w in want.items())


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_train_step_on_card_matches_the_cpu(cuda, arch, pipelined):
    """One smoke train step in float32 on the card against the same step
    on the CPU, within tests/test_torch_train.py's bars (the loss 2e-5,
    moments 1e-4 of the leaf's max + 1e-6 of the max over leaves,
    parameters 1e-6 + 1e-7), with no flash or wkv launch."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    tcfg = TrainConfig(model=cfg.name, steps=10, warmup_steps=2,
                       learning_rate=1e-3, pipelined_clipping=pipelined)
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, 32, 2, seed=4),
                            device="cpu").batch(0)
    out = {}
    ops.reset_launch_counts()
    for dev in ("cpu", cuda):
        state = _moments_state(cfg, tcfg, dev)
        state, metrics = make_train_step(cfg, tcfg)(
            state, {k: t.to(dev) for k, t in batch.items()})
        out[str(dev)] = (state, metrics)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["wkv_recurrent"] == 0
    (cs, cm), (gs, gm) = out["cpu"], out[str(cuda)]
    assert abs(float(gm["loss"]) - float(cm["loss"])) <= 2e-5
    assert float(gm["gnorm"]) == pytest.approx(float(cm["gnorm"]), rel=1e-5)
    assert float(gm["lr"]) == float(cm["lr"])
    for key in ("m", "v"):
        assert _bar_ok(gs["opt"][key], cs["opt"][key], 1e-4, 1e-6), key
    gp = dict(gs["params"].named_parameters())
    cp = {k: p.detach() for k, p in cs["params"].named_parameters()}
    assert _bar_ok({k: p.detach() for k, p in gp.items()}, cp, 1e-6, 1e-7)


@pytest.mark.cuda
def test_restart_repeats_the_run_bit_for_bit_on_card(cuda, tmp_path):
    """qwen3 smoke, 10 steps with a checkpoint at 6 on the card; a run
    restored at step 6 repeats the last 4 losses and the final parameters
    bit for bit (the gradient sums run in a fixed order, ROADMAP.md H2)."""
    import shutil
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.train import train
    cfg = smoke_config("qwen3-1.7b")
    full, cut = tmp_path / "full", tmp_path / "cut"
    kw = dict(seq_len=64, batch=4, log_every=0, device=cuda)
    out = train(cfg, TrainConfig(model=cfg.name, steps=10,
                                 checkpoint_dir=str(full),
                                 checkpoint_every=6,
                                 pipelined_clipping=True), **kw)
    cut.mkdir()
    shutil.copytree(full / "step_0000000006", cut / "step_0000000006")
    (cut / "LATEST").write_text("6")
    out2 = train(cfg, TrainConfig(model=cfg.name, steps=10,
                                  checkpoint_dir=str(cut),
                                  pipelined_clipping=True), **kw)
    assert out2["steps"] == 4
    assert out2["losses"] == out["losses"][6:]
    for (k, a), (_, b) in zip(out["state"]["params"].named_parameters(),
                              out2["state"]["params"].named_parameters()):
        assert torch.equal(a, b), k


@pytest.mark.cuda
def test_train_step_with_flash_kernel_raises_on_card(cuda):
    """``attn_kernel=True`` in a train step reaches the flash wrapper with
    inputs autograd records: it raises, launching nothing (``train``
    refuses such a config before step 0)."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_state
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), attn_kernel=True,
                              head_dim=64)   # a head dim the kernel takes
    tcfg = TrainConfig(model=cfg.name)
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 2),
                            device=cuda).batch(0)
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(cfg, tcfg)(build_state(cfg, tcfg, device=cuda),
                                   batch)
    assert ops.launch_counts()["flash_attention"] == before


# -- sharded models on 4 ranks of the card --------------------------------

SHARD_WORLD = 4


def _shard_batch(vocab, B=4, S=64, seed=3):
    import numpy as np
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": g.integers(0, vocab, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def sharded_on_card():
    """One spawn of 4 ranks on the card (gloo unless each has a card) for
    every sharded case, and the one-device results beside them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    import numpy as np
    import torch_sharded_ranks as tsr
    from repro_torch.distributed import ranks
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params, loss_fn
    dev = torch.device("cuda")
    kw = dict(capacity="no_drop")
    flash = dict(overrides={"head_dim": 64, "attn_kernel": True,
                            "moe_impl": "ep"}, **kw)
    cfgs = {"qwen3": dict(arch="qwen3-1.7b", **kw),
            "olmoe": dict(arch="olmoe-1b-7b", overrides={"moe_impl": "ep"},
                          **kw),
            "flash": dict(arch="olmoe-1b-7b", **flash)}
    vocab = tsr.config("qwen3-1.7b").vocab_size
    g = np.random.default_rng(7)
    m = tsr.config("olmoe-1b-7b").moe
    d = tsr.config("olmoe-1b-7b").d_model
    moe = {"router": g.standard_normal((d, m.num_experts)) * 0.5,
           "up": g.standard_normal((m.num_experts, d, m.d_ff)) * 0.1,
           "gate": g.standard_normal((m.num_experts, d, m.d_ff)) * 0.1,
           "down": g.standard_normal((m.num_experts, m.d_ff, d)) * 0.1}
    moe = {k: v.astype(np.float32) for k, v in moe.items()}
    x = g.standard_normal((4, 64, d)).astype(np.float32)
    jobs = [dict(kind="grads", model=2, cfg=cfgs["qwen3"],
                 batch=_shard_batch(vocab)),
            dict(kind="grads", model=2,
                 cfg=dict(cfgs["qwen3"], overrides={"sharding": "fsdp"}),
                 batch=_shard_batch(vocab)),
            dict(kind="moe_ep", model=2, moe=moe, x=x,
                 cfg=dict(arch="olmoe-1b-7b", **kw)),
            dict(kind="storage", model=2, cfg=cfgs["olmoe"]),
            dict(kind="storage", model=1,
                 cfg=dict(cfgs["qwen3"], overrides={"sharding": "fsdp"})),
            dict(kind="prefill", model=2, cfg=cfgs["flash"],
                 batch={"tokens": _shard_batch(vocab)["tokens"]})]
    out = ranks.run(tsr.sharded_jobs, SHARD_WORLD, jobs, "cuda",
                    device="cuda")
    one = {}
    cfg = tsr.config(**cfgs["qwen3"])
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    b = {k: torch.from_numpy(v).to(dev) for k, v in
         _shard_batch(vocab).items()}
    loss, _ = loss_fn(model, cfg, b)
    one["loss"] = float(loss.detach())
    one["grads"] = {k: v.cpu().numpy() for k, v in zip(
        named, torch.autograd.grad(loss, list(named.values())))}
    cfg = tsr.config(**dict(cfgs["flash"], overrides=dict(
        flash["overrides"], moe_impl="gather")))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    logits, _ = make_prefill_step(cfg)(model, {"tokens": b["tokens"]})
    one["logits"] = logits.float().cpu().numpy()
    return dict(jobs=jobs, out=out, one=one)


def _shard_recs(run, i):
    return [run["out"][r][i] for r in range(SHARD_WORLD)]


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 1])
def test_sharded_loss_and_grads_equal_one_device_on_card(sharded_on_card, i):
    """qwen3 smoke, "2d" and "fsdp" on (2, 2): the sharded loss
    within 1e-5 of one device's, each gradient block within 1e-4 of its
    leaf's max |g| (the sums run in another order)."""
    import numpy as np
    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import split_dims
    from repro_torch.launch.mesh import Mesh
    run = sharded_on_card
    one = run["one"]
    for rec in _shard_recs(run, i):
        assert abs(rec["loss"] - one["loss"]) <= 1e-5
        shape, c = rec["shape"], rec["coords"]
        mesh = Mesh(shape, c["data"] * shape["model"] + c["model"])
        for k, g in one["grads"].items():
            t = torch.from_numpy(g)
            for dim, axes in split_dims(rec["specs"][k]):
                t = comm.own_block(t, dim, mesh, axes)
            bar = 1e-4 * float(np.abs(g).max()) + 1e-7
            assert float(np.abs(rec["grads"][k] - t.numpy()).max()) <= bar


@pytest.mark.cuda
def test_expert_route_equals_gather_route_at_no_drop_on_card(
        sharded_on_card):
    import numpy as np
    for rec in _shard_recs(sharded_on_card, 2):
        assert rec["aux"]["moe_dropped"] == 0
        np.testing.assert_allclose(rec["out"], rec["gather_out"], rtol=0,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("i", [3, 4])
def test_sharded_storage_is_each_ranks_share_on_card(sharded_on_card, i):
    for rec in _shard_recs(sharded_on_card, i):
        assert rec["held"] == rec["plan"]


@pytest.mark.cuda
def test_sharded_prefill_launches_one_flash_per_layer_per_rank(
        sharded_on_card):
    """olmoe smoke (head dim 64, the expert route) on (2, 2): every rank
    launches one flash kernel per attention layer, and its rows of the
    logits are one device's (gather route) within 1e-3."""
    import numpy as np
    import torch_sharded_ranks as tsr
    layers = tsr.config("olmoe-1b-7b").num_layers
    want = sharded_on_card["one"]["logits"]
    for rec in _shard_recs(sharded_on_card, 5):
        assert rec["launches"]["flash_attention"] == layers
        assert sum(rec["launches"].values()) == layers
        d, n = rec["coords"]["data"], rec["rows"]
        assert float(np.abs(rec["logits"] - want[d * n:(d + 1) * n]).max()) \
            <= 1e-3


@pytest.mark.cuda
def test_tensor_parallel_prefill_launches_flash_on_half_the_heads():
    """qwen3 smoke (head dim 64, H 4, KV 2) with its heads split over 2
    ranks of the card ("2d", mesh (1, 2)): each rank launches the flash
    kernel once per attention layer, on its H/2 heads of every row, and
    its logits are one device's within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    import numpy as np
    import torch_sharded_ranks as tsr
    from repro_torch.distributed import ranks
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params
    kw = dict(arch="qwen3-1.7b", overrides={
        "head_dim": 64, "attn_kernel": True, "shard_attn_heads": True})
    cfg = tsr.config(**kw)
    tokens = _shard_batch(cfg.vocab_size)["tokens"]
    out = ranks.run(tsr.sharded_jobs, 2, [dict(
        kind="prefill", model=2, cfg=kw, batch={"tokens": tokens})], "cuda",
        device="cuda")
    dev = torch.device("cuda")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    want, _ = make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(tokens).to(dev)})
    want = want.float().cpu().numpy()
    B, S = tokens.shape
    for (rec,) in out:
        assert rec["launches"]["flash_attention"] == cfg.num_layers
        assert sum(rec["launches"].values()) == cfg.num_layers
        assert rec["flash_shapes"] == [(B * cfg.num_heads // 2, S, 64)] \
            * cfg.num_layers
        assert float(np.abs(rec["logits"] - want).max()) <= 1e-3
