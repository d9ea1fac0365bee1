"""The port's many-rank solves against the JAX package, on gloo CPU ranks.

One spawn per world size (1, 2, 4 ranks, ``repro_torch.distributed.ranks``)
runs every case of ``CASES`` through ``distributed_solve``; the parent
holds each rank's result against the JAX package's single-device solve of
the same numpy inputs (``engine="naive"`` or the inline path: the Pallas
kernels do not run under this JAX, ROADMAP.md queue 3, H1).  The halo
sweep runs as its plain version here; tests/test_torch_cuda.py and
chip_smoke.py hold the kernel against it on the card.

Tolerances: residual histories to rtol 1e-10 above a 1e-10 relative floor
over at most 80 iterations (ROADMAP.md queue 3, H6; 12 with bf16 storage),
``x`` to 1e-10 of its largest entry, ``iters`` exactly; every rank returns
the same result.  p-BiCGStab on the nonsymmetric convection-diffusion
operator falls 1e-4 in about 25 iterations, and its Gram polynomials carry
a rounding-order difference to ~1e-11 by 20, so its cases run at most 20
iterations before they are compared (a tol case freezes inside that
window).  The bf16 p-BiCGStab case runs on an operator whose bands bf16
rounds and is held against the JAX package's sharded body on a one-device
mesh (:func:`_jax_sharded_low_precision`); its ABFT row reads the
demotion error of the column sums, so it is held to that row to rtol 1e-9
instead of to the rounding bound 1e-9 (ROUNDED_BANDS).

The depth-l cases (``pipecg_l``, l = 2 and 4) are held against the JAX
package's local ``pipecg_l(engine="naive")`` and the port's one-device
``pipecg_l(engine="fused")`` to rtol 1e-10, their tol case freezing at
the same block; the bf16 depth case against the JAX package's sharded
depth body on a one-device mesh with its chain kernel replaced by the
TPU kernel's arithmetic in jnp (:func:`_jax_sharded_depth_low_precision`).

The geometry cases are the JAX package's own
(tests/test_engine_equivalence.py::test_operator_geometry_distributed_equivalence):
``dia_to_bsr(glen_law_band(256, bandwidth=8), bs=4)`` on the chain of
ranks, 80 iterates, and ``laplacian_2d(16, 8)`` on (1, 2) and (2, 2)
grids, or (2, 1) and (4, 1), 60 iterates, plain and Jacobi, through the
plain-torch BSR and 2-D bodies, and a tol solve of each (the reference's
BSR Jacobi case at tol 1e-12; the grid at 1e-3, where the state it
freezes on still moves), which freezes one iteration after the local
solve, as the chain body's does.  Their x is held within the reference's
``TOL = 1e-10`` of the JAX package's single-device naive solve; these
small operators converge within 15-45 iterations, so their histories are
held to rtol 1e-10 above 1e-4 of the first residual (H6), where the
rounding-order tail past it is measured at 1e-10 to 3e-8.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import repro.core.krylov as jk
from jax.sharding import Mesh
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.checksum import dia_column_checksum as jcolsum
from repro.core.noise.injection import NoiseHook as JNoiseHook
from repro.core.perfmodel.distributions import Exponential as JExponential
from repro_torch import convert
from repro.core.krylov.operator import dia_to_bsr as j_dia_to_bsr
from repro_torch.core.krylov import (PrecisionPolicy, SolverOptions, cg,
                                     distributed_solve, pipebicgstab, pipecg,
                                     pipecg_l, pipecg_multi, pipecr)
from repro_torch.distributed import comm
from repro_torch.core.krylov.engine import get_engine
from repro_torch.core.noise import NoiseHook, sample_np, scale_distribution
from repro_torch.core.noise.traces import EmpiricalDistribution
from repro_torch.core.perfmodel import Exponential, LogNormal, Uniform
from repro_torch.distributed import ranks
from repro_torch.distributed.overlap import depth_order_ok, split_phase_ok

SCALE = 1e-5   # seconds per unit noise draw: 10 us mean waits


def _spd_tridiag(n, seed):
    """Symmetric tridiagonal SPD with a varying diagonal (Jacobi matters)."""
    rng = np.random.default_rng(seed)
    off = -rng.uniform(0.5, 1.0, n)
    lo = np.concatenate([[0.0], off[:-1]])
    hi = np.concatenate([off[:-1], [0.0]])
    main = np.abs(lo) + np.abs(hi) + rng.uniform(1e-3, 2e-2, n)
    return jk.DiaMatrix(offsets=(-1, 0, 1),
                        bands=jnp.asarray(np.stack([lo, main, hi])))


OPS = {"ex23": jk.tridiagonal_laplacian(4096),
       "lap2d": jk.laplacian_2d(16, 16),
       "spd": _spd_tridiag(512, seed=3),
       "cd": jk.convection_diffusion(4096),
       "glen-bsr": j_dia_to_bsr(jk.glen_law_band(256, bandwidth=8), bs=4),
       "lap2d-16x8": jk.laplacian_2d(16, 8)}
RHS = {"ex23": np.random.default_rng(0).standard_normal(4096),
       "lap2d": np.random.default_rng(1).standard_normal(256),
       "spd": np.random.default_rng(2).standard_normal(512),
       "multi": np.random.default_rng(3).standard_normal((3, 4096)),
       "cd": np.random.default_rng(4).standard_normal(4096),
       "glen-bsr": np.random.default_rng(0).standard_normal(256),
       "lap2d-16x8": np.random.default_rng(0).standard_normal(128)}
# (py, px) process grids of the 2-D cases, by world size
GRIDS = {"wide": {1: (1, 1), 2: (1, 2), 4: (2, 2)},
         "tall": {1: (1, 1), 2: (2, 1), 4: (4, 1)}}
SHARDED = dict(engine="sharded_fused")

# name: (solver, operator, rhs, distributed_solve kwargs, noise?)
CASES = {
    "pipecg": ("pipecg", "ex23", "ex23", dict(SHARDED, maxiter=80), False),
    "pipecr": ("pipecr", "ex23", "ex23", dict(SHARDED, maxiter=80), False),
    "pipecg-jacobi": ("pipecg", "spd", "spd",
                      dict(SHARDED, maxiter=60, M="jacobi"), False),
    "pipecg-lap2d": ("pipecg", "lap2d", "lap2d", dict(SHARDED, maxiter=20),
                     False),
    "pipecg-tol": ("pipecg", "spd", "spd",
                   dict(SHARDED, maxiter=80, tol=3e-2), False),
    "pipecg_multi": ("pipecg_multi", "ex23", "multi",
                     dict(SHARDED, maxiter=60), False),
    "pipecg-bf16": ("pipecg", "ex23", "ex23",
                    dict(SHARDED, maxiter=12, precision="bf16"), False),
    "pipecg-noise": ("pipecg", "ex23", "ex23", dict(SHARDED, maxiter=80),
                     True),
    "cg-inline": ("cg", "ex23", "ex23", dict(maxiter=80), False),
    "cr-inline": ("cr", "lap2d", "lap2d", dict(maxiter=20), False),
    "pipecg-inline": ("pipecg", "ex23", "ex23", dict(maxiter=80), False),
    "pipecr-inline": ("pipecr", "lap2d", "lap2d", dict(maxiter=20), False),
    "cg-inline-noise": ("cg", "ex23", "ex23", dict(maxiter=80), True),
    "pipebicgstab": ("pipebicgstab", "cd", "cd", dict(SHARDED, maxiter=20),
                     False),
    "pipebicgstab-jacobi": ("pipebicgstab", "cd", "cd",
                            dict(SHARDED, maxiter=20, M="jacobi"), False),
    "pipebicgstab-lap2d": ("pipebicgstab", "lap2d", "lap2d",
                           dict(SHARDED, maxiter=15), False),
    "pipebicgstab-tol": ("pipebicgstab", "cd", "cd",
                         dict(SHARDED, maxiter=30, tol=1e-3), False),
    # bf16 rounds every band of "cd" (-1.4, 2.2, -0.6)
    "pipebicgstab-bf16": ("pipebicgstab", "cd", "cd",
                          dict(SHARDED, maxiter=12, precision="bf16"), False),
    "pipebicgstab-noise": ("pipebicgstab", "cd", "cd",
                           dict(SHARDED, maxiter=20), True),
    "pipebicgstab-inline": ("pipebicgstab", "cd", "cd", dict(maxiter=20),
                            False),
    "depth2": ("pipecg_l", "ex23", "ex23", dict(SHARDED, maxiter=80, l=2),
               False),
    "depth4": ("pipecg_l", "ex23", "ex23", dict(SHARDED, maxiter=80, l=4),
               False),
    "depth2-lap2d": ("pipecg_l", "lap2d", "lap2d",
                     dict(SHARDED, maxiter=20, l=2), False),
    "depth2-jacobi": ("pipecg_l", "spd", "spd",
                      dict(SHARDED, maxiter=60, l=2, M="jacobi"), False),
    "depth2-tol": ("pipecg_l", "spd", "spd",
                   dict(SHARDED, maxiter=80, l=2, tol=3e-2), False),
    # bf16 rounds the random bands of "spd"
    "depth2-bf16": ("pipecg_l", "spd", "spd",
                    dict(SHARDED, maxiter=12, l=2, precision="bf16"), False),
    "depth2-noise": ("pipecg_l", "ex23", "ex23",
                     dict(SHARDED, maxiter=80, l=2), True),
    "bsr": ("pipecg", "glen-bsr", "glen-bsr", dict(SHARDED, maxiter=80),
            False),
    "bsr-jacobi": ("pipecg", "glen-bsr", "glen-bsr",
                   dict(SHARDED, maxiter=80, M="jacobi"), False),
    "bsr-jacobi-tol": ("pipecg", "glen-bsr", "glen-bsr",
                       dict(SHARDED, maxiter=80, M="jacobi", tol=1e-12),
                       False),
    "grid-wide": ("pipecg", "lap2d-16x8", "lap2d-16x8",
                  dict(SHARDED, maxiter=60, grid="wide"), False),
    "grid-wide-jacobi": ("pipecg", "lap2d-16x8", "lap2d-16x8",
                         dict(SHARDED, maxiter=60, grid="wide", M="jacobi"),
                         False),
    "grid-tall": ("pipecg", "lap2d-16x8", "lap2d-16x8",
                  dict(SHARDED, maxiter=60, grid="tall"), False),
    "grid-tall-jacobi": ("pipecg", "lap2d-16x8", "lap2d-16x8",
                         dict(SHARDED, maxiter=60, grid="tall", M="jacobi"),
                         False),
    "grid-wide-tol": ("pipecg", "lap2d-16x8", "lap2d-16x8",
                      dict(SHARDED, maxiter=60, grid="wide", tol=1e-3),
                      False),
}
GEOMETRY = [n for n, c in CASES.items() if c[1] in ("glen-bsr", "lap2d-16x8")]
DEPTH = [n for n, c in CASES.items() if c[0] == "pipecg_l"]
NAMES = list(CASES)


def _port_op(name):
    A = OPS[name]
    if A.format == "bsr":
        return convert.bsr_from_numpy(np.asarray(A.indices),
                                      np.asarray(A.blocks), device="cpu")
    return convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                  grid_shape=A.grid_shape, device="cpu")


def _cases(world):
    out = []
    for solver, op, rhs, kw, noisy in CASES.values():
        kw = dict(kw)
        grid = kw.pop("grid", None)
        out.append(dict(solver=solver, A=_port_op(op),
                        b=torch.from_numpy(RHS[rhs].copy()), kw=kw,
                        noise=(Exponential(1.0), SCALE, 0) if noisy
                        else None,
                        grid=None if grid is None else GRIDS[grid][world]))
    return out


def _reference(name):
    """The JAX package's single-device solve of the case (numpy result)."""
    solver, op, rhs, kw, _ = CASES[name]
    A, b = OPS[op], jnp.asarray(RHS[rhs])
    it = kw["maxiter"]
    if solver == "pipecg_multi":
        return jk.pipecg_multi(A, b, maxiter=it, engine="naive")
    if kw.get("precision") and solver == "pipebicgstab":
        return _jax_sharded_low_precision(A, b, kw)
    if kw.get("precision") and solver == "pipecg_l":
        return _jax_sharded_depth_low_precision(A, b, kw)
    if kw.get("precision"):
        # the JAX fused path reaches Pallas; the port's single-device bf16
        # sweep is held against the reference sweep in test_torch_solvers
        return pipecg(_port_op(op), torch.from_numpy(RHS[rhs].copy()),
                      options=SolverOptions(maxiter=it, engine="fused",
                                            precision=kw["precision"]))
    opts = dict(maxiter=it, tol=kw.get("tol", 0.0), M=kw.get("M"))
    if name in GEOMETRY:   # the reference's own oracle: the naive solve
        return getattr(jk, solver)(A, b, options=jk.SolverOptions(
            engine="naive", **opts))
    if kw.get("engine"):
        opts["engine"] = "naive"
    if "l" in kw:
        opts["depth"] = kw["l"]
    return getattr(jk, solver)(A, b, options=jk.SolverOptions(**opts))


def _jax_sharded_low_precision(A, b, kw):
    """The JAX package's sharded p-BiCGStab body on a one-device mesh.

    Its halo kernel is a Pallas kernel (H1), so the sweep is
    ``ref.pipebicgstab_fused_ref`` at the kernel's dtypes: the stored
    chains and the operator extension widen to x's dtype, the six chain
    outputs narrow back to their storage dtype, x and the Gram stay wide.
    Row 6 takes c = A^T 1 as the JAX halo wrapper does: the column sums
    of the demoted extension, summed at the storage dtype (the port's
    body does the same on every iteration; both set-up rows take the
    full-precision operator's, H9).
    """
    assert kw.get("M") is None   # c below is that of the unfolded bands
    h = max(abs(o) for o in A.offsets)

    def sweep(offsets, bands_ext, x, r, w, t, pa, a, c, r_hat, *strips,
              **_):
        alpha, beta, omega = strips[-3:]   # one device: the strips are 0
        csum = jcolsum(offsets, bands_ext, halo=h).astype(x.dtype)
        wide = [v.astype(x.dtype) for v in (r, w, t, pa, a, c, r_hat)]
        x2, *chains, G = ref.pipebicgstab_fused_ref(
            offsets, bands_ext[:, h:-h].astype(x.dtype), x, *wide,
            alpha, beta, omega)
        G = G.at[6, 0].set(jnp.sum(chains[2]) - jnp.sum(csum * chains[1]))
        return (x2, *(v.astype(r.dtype) for v in chains), G)

    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "pipebicgstab_halo_step", sweep)
        return jk.distributed_solve(jk.pipebicgstab, A, b, mesh, **kw)


def _jax_sharded_depth_low_precision(A, b, kw):
    """The JAX package's sharded depth body on a one-device mesh.

    Its chain kernel is a Pallas kernel (H1), so the sweep is the TPU
    kernel's arithmetic (``_chain_kernel``) in jnp: p, r, the strips and
    the operator extension widen to the accumulator, each link is zero +
    band_k * (link at row + off_k) in band order times 1/theta, the Gram
    is taken at the accumulator and only the chain narrows back.
    """
    def sweep(offsets, bands_ext, p, r, p_l, p_r, r_l, r_r, theta, l,
              accum_dtype=None, **_):
        acc = accum_dtype or jnp.promote_types(p.dtype, jnp.float32)
        h = max(abs(o) for o in offsets)
        H, n = l * h, p.shape[0]
        th_inv = 1.0 / jnp.asarray(theta, acc)
        bands = bands_ext.astype(acc)

        def links(v, depth):
            a = v.astype(acc)
            out = [a[H:H + n]]
            for j in range(1, depth + 1):
                width = n + 2 * (H - j * h)
                nxt = jnp.zeros((width,), acc)
                for k, off in enumerate(offsets):
                    nxt = nxt + bands[k, j * h:j * h + width] \
                        * a[h + off:h + off + width]
                a = nxt * th_inv
                out.append(a[H - j * h:H - j * h + n])
            return out

        C = jnp.stack(links(jnp.concatenate([p_l, p, p_r]), l)
                      + links(jnp.concatenate([r_l, r, r_r]), l - 1))
        return C.astype(p.dtype), C @ C.T

    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "ghost_chain_halo_step", sweep)
        return jk.distributed_solve(jk.pipecg_l, A, b, mesh, **kw)


@pytest.fixture(scope="module")
def references():
    return {name: _reference(name) for name in NAMES}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"P{p}")
def runs(request):
    world = request.param
    return world, ranks.run(ranks.solve_cases, world, _cases(world), "cpu",
                            device="cpu")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _hist_close(want, got, rtol=1e-10, floor_rel=1e-10):
    hw, hg = _np(want), _np(got)
    assert hw.shape == hg.shape
    mask = hw > floor_rel * max(hw.max(), 1.0)
    assert mask.sum() > 0
    np.testing.assert_allclose(hg[mask], hw[mask], rtol=rtol)


@pytest.mark.parametrize("name", NAMES)
def test_distributed_solve_matches_reference(runs, references, name):
    world, per_rank = runs
    i = NAMES.index(name)
    got = per_rank[0][i]
    want = references[name]
    if CASES[name][3].get("tol") and CASES[name][0] not in ("pipebicgstab",
                                                            "pipecg_l"):
        # the split-phase body sees ||r_i|| one iteration late, so it
        # freezes one iteration after the local solver does (as the JAX
        # package's sharded body does), on the state one step further on
        lag = int(want.iters) + 1
        assert int(got["iters"]) == lag < CASES[name][3]["maxiter"]
        _hist_close(_np(want.res_history)[:lag - 1],
                    got["res_history"][:lag - 1],
                    floor_rel=1e-4 if name in GEOMETRY else 1e-10)
        solver, op, rhs, kw, _ = CASES[name]
        want = jk.pipecg(OPS[op], jnp.asarray(RHS[rhs]),
                         options=jk.SolverOptions(maxiter=lag + 1,
                                                  engine="naive",
                                                  M=kw.get("M")))
    else:
        # p-BiCGStab detects convergence from the carried Gram on one
        # device too, and the depth body consumes its Gram in the block
        # that takes it, so a tol case freezes at the same iteration
        _hist_close(want.res_history, got["res_history"],
                    floor_rel=1e-4 if name in GEOMETRY else 1e-10)
        np.testing.assert_array_equal(got["iters"], _np(want.iters))
        if CASES[name][3].get("tol"):
            assert int(got["iters"]) < CASES[name][3]["maxiter"]
    xw = _np(want.x)
    assert got["x"].shape == xw.shape
    np.testing.assert_allclose(got["x"], xw, rtol=0,
                               atol=1e-10 * np.abs(xw).max())
    if name in GEOMETRY:   # the reference's own gate, TOL = 1e-10
        assert np.abs(got["x"] - xw).max() < 1e-10
    for other in per_rank[1:]:
        for key in ("x", "iters", "res_norm", "res_history"):
            np.testing.assert_array_equal(other[i][key], got[key])
    assert sum(got["launches"].values()) == 0   # plain versions on the CPU


# The ABFT checksum column stays below 1e-9, a rounding level (a corrupted
# sweep moves it by O(1)).  The PIPECG and p-BiCGStab sweeps check the
# operator they stream: with bf16 storage their c is the column sums of
# the demoted bands, as the JAX halo wrappers sum them (H9), so the
# column stays at rounding level where bf16 rounds the bands ("cd": -1.4,
# 2.2, -0.6) too.  The depth body's deviation row takes the
# full-precision c, as the JAX depth body does, so where bf16 rounds the
# bands it reads the demotion error, ~1e-3: such a case is held to the
# reference's row to rtol 1e-9 instead.
ROUNDED_BANDS = {"depth2-bf16"}


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if CASES[n][3].get("engine")])
def test_sharded_split_phase_order_and_detector(runs, references, name):
    """H5: issue(i) < halo(i+1) < wait(i) < launch(i+1), one all-reduce
    per iteration, on every rank; the detector column within its bound."""
    _, per_rank = runs
    i = NAMES.index(name)
    for outcome in per_rank:
        assert outcome[i]["order_ok"] is True
        det = outcome[i]["detect_history"]
        assert det.shape == outcome[i]["res_history"].shape
        if name not in ROUNDED_BANDS:
            assert np.abs(det).max() < 1e-9
        else:
            want = _np(references[name].detect_history)
            np.testing.assert_allclose(det, want, rtol=1e-9)
            assert np.abs(want).min() > 1e-6   # not a rounding level


def test_bf16_storage_changes_the_pipebicgstab_history(runs):
    """bf16 storage is real: the rounded chains and bands take the history
    away from the float64 one of the same solve."""
    _, per_rank = runs
    low = per_rank[0][NAMES.index("pipebicgstab-bf16")]["res_history"]
    full = per_rank[0][NAMES.index("pipebicgstab")]["res_history"]
    rel = np.abs(low - full[:low.size]) / full[:low.size]
    assert rel.max() > 1e-2


def test_noise_only_delays(runs):
    """The noisy solve equals the quiet one bit for bit; every rank's
    waits are the draws of its substream (seed 0, shard = rank)."""
    world, per_rank = runs
    # sharded: one wait per iteration (per block at depth l); inline cg:
    # one per SpMV, two of them at set-up
    for quiet, noisy, n_waits in (("pipecg", "pipecg-noise", 80),
                                  ("cg-inline", "cg-inline-noise", 82),
                                  ("pipebicgstab", "pipebicgstab-noise", 20),
                                  ("depth2", "depth2-noise", 40)):
        qi, ni = NAMES.index(quiet), NAMES.index(noisy)
        for rank, outcome in enumerate(per_rank):
            q, nz = outcome[qi], outcome[ni]
            for key in ("x", "res_history"):
                np.testing.assert_array_equal(nz[key], q[key])
            waits = nz["waits"]
            draws = np.random.default_rng((0, rank)).exponential(
                1.0, size=waits.shape) * SCALE
            np.testing.assert_array_equal(waits, draws)
            assert waits.size == n_waits
        assert world == len(per_rank)


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_bodies_reduce_once_per_iteration(runs, name):
    """The BSR and 2-D bodies: one recorded all-reduce per iteration (and
    the set-up's) in the H5 order on every rank, the tolerance scale the
    one blocking all-reduce; on a grid, every rank holds its tile."""
    world, per_rank = runs
    i = NAMES.index(name)
    maxiter = CASES[name][3]["maxiter"]
    for outcome in per_rank:
        assert outcome[i]["order_ok"] is True
        assert outcome[i]["reductions"] == maxiter + 1
        assert outcome[i]["all_reduces"] == 1
        assert outcome[i]["res_history"].shape == (maxiter,)
    assert len(per_rank) == world


@pytest.mark.parametrize("name", [n for n in DEPTH
                                  if not CASES[n][3].get("precision")])
def test_sharded_depth_matches_the_port_one_device(runs, name):
    """The depth body on P ranks equals the port's one-device pipecg_l
    through the chain kernel's plain version, block for block."""
    _, per_rank = runs
    got = per_rank[0][NAMES.index(name)]
    _, op, rhs, kw, _ = CASES[name]
    one = pipecg_l(_port_op(op), torch.from_numpy(RHS[rhs].copy()),
                   options=SolverOptions(
                       maxiter=kw["maxiter"], tol=kw.get("tol", 0.0),
                       M=kw.get("M"), depth=kw["l"], engine="fused"))
    _hist_close(one.res_history, got["res_history"])
    np.testing.assert_array_equal(got["iters"], one.iters.numpy())
    xw = one.x.numpy()
    np.testing.assert_allclose(got["x"], xw, rtol=0,
                               atol=1e-10 * np.abs(xw).max())


@pytest.mark.parametrize("name", DEPTH)
def test_depth_reduces_once_per_block(runs, name):
    """One recorded all-reduce per block of l iterations and the depth
    order on every rank; the blocking ones are the set-up's two (theta,
    the tolerance scale) and the final residual's."""
    _, per_rank = runs
    i = NAMES.index(name)
    kw = CASES[name][3]
    blocks = -(-kw["maxiter"] // kw["l"])
    for outcome in per_rank:
        assert outcome[i]["reductions"] == blocks
        assert outcome[i]["all_reduces"] == 3
        assert outcome[i]["order_ok"] is True


def test_bf16_storage_changes_the_depth_history(runs):
    _, per_rank = runs
    low = per_rank[0][NAMES.index("depth2-bf16")]["res_history"]
    full = _np(pipecg_l(_port_op("spd"), torch.from_numpy(RHS["spd"].copy()),
                        options=SolverOptions(maxiter=12, depth=2,
                                              engine="fused")).res_history)
    assert np.max(np.abs(low - full) / full) > 1e-3


def test_depth_order_ok_rejects_wrong_orders():
    good = []
    for b in range(3):
        good += [("halo", b), ("launch", b), ("issue", b), ("wait", b)]
    assert depth_order_ok(good, 3)
    swapped = list(good)
    swapped[1], swapped[2] = swapped[2], swapped[1]    # issue before launch
    assert not depth_order_ok(swapped, 3)
    late = list(good)
    late[3], late[4] = late[4], late[3]    # next halo before this wait
    assert not depth_order_ok(late, 3)
    assert not depth_order_ok(good + [("issue", 1)], 3)   # a second reduce
    assert not depth_order_ok(good[:-1], 3)
    assert not split_phase_ok(good, 3)


def test_inline_pipebicgstab_reduces_once_per_iteration(runs):
    """The inline path finishes the (6, 6) Gram with ONE all-reduce per
    iteration (gram_reduce), plus one for ||b|| and one for the initial
    Gram; the sharded body issues none of the blocking kind."""
    _, per_rank = runs
    inline = NAMES.index("pipebicgstab-inline")
    sharded = NAMES.index("pipebicgstab")
    for outcome in per_rank:
        assert outcome[inline]["all_reduces"] == \
            CASES["pipebicgstab-inline"][3]["maxiter"] + 2
        assert outcome[sharded]["all_reduces"] == 1


# -- in-process pieces ---------------------------------------------------------

@pytest.mark.parametrize("dist_name", ["exponential", "uniform", "lognormal",
                                       "trace"])
def test_noise_hook_draws_equal_the_jax_hook(dist_name):
    from repro.core.noise.traces import EmpiricalDistribution as JEmp
    from repro.core.perfmodel.distributions import LogNormal as JLogNormal
    from repro.core.perfmodel.distributions import Uniform as JUniform
    trace = np.random.default_rng(5).exponential(1.0, 64)
    ours, theirs = {
        "exponential": (Exponential(2.0), JExponential(2.0)),
        "uniform": (Uniform(0.5, 1.5), JUniform(0.5, 1.5)),
        "lognormal": (LogNormal(0.1, 0.5), JLogNormal(0.1, 0.5)),
        "trace": (EmpiricalDistribution.from_samples(trace),
                  JEmp.from_samples(trace)),
    }[dist_name]
    a, b = NoiseHook(ours, scale=1e-3, seed=7), JNoiseHook(theirs, scale=1e-3,
                                                           seed=7)
    for shard in (0, 3, 1):
        got = [a.sample(shard) for _ in range(5)]
        want = [b.sample(shard) for _ in range(5)]
        assert got == want
        np.testing.assert_array_equal(a.shard_waits(shard),
                                      b.shard_waits(shard))


def test_sampling_fallback_and_scaling():
    from repro_torch.core.perfmodel import Gamma
    rng = np.random.default_rng(0)
    draws = sample_np(Gamma(2.0, 1.0), rng, (2000,))
    assert draws.dtype == np.float64 and abs(draws.mean() - 2.0) < 0.15
    assert scale_distribution(Exponential(2.0), 0.5) == Exponential(4.0)
    emp = EmpiricalDistribution.from_samples([3.0, 1.0, 2.0])
    np.testing.assert_allclose(
        emp.quantile(torch.tensor([0.0, 0.5, 1.0])).numpy(), [1.0, 2.0, 3.0])
    assert float(emp.cdf(torch.tensor(2.0))) == pytest.approx(2 / 3)
    with pytest.raises(TypeError):
        scale_distribution(Gamma(2.0, 1.0), 2.0)


def test_split_phase_ok_rejects_wrong_orders():
    good = [("issue", -1)]
    for i in range(3):
        good += [("halo", i), ("wait", i - 1), ("launch", i), ("issue", i)]
    good.append(("wait", 2))
    assert split_phase_ok(good, 3)
    late_halo = list(good)
    late_halo[1], late_halo[2] = late_halo[2], late_halo[1]   # wait first
    assert not split_phase_ok(late_halo, 3)
    early_launch = list(good)
    early_launch[2], early_launch[3] = early_launch[3], early_launch[2]
    assert not split_phase_ok(early_launch, 3)
    assert not split_phase_ok(good + [("issue", 5)], 3)   # a second reduce
    assert not split_phase_ok(good[:-1], 3)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process (errors raise before any
    communication is needed, or need only this rank)."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_unsupported_options_raise(one_rank):
    T = _port_op("ex23")
    b = torch.from_numpy(RHS["ex23"].copy())
    cases = [
        (ValueError, "needs solver pipecg_l",
         dict(engine="sharded_fused", l=2)),
        (ValueError, "not both",
         dict(engine="sharded_fused", x0=torch.zeros(4096),
              carried=dict(x=torch.zeros(1, 4096)))),
        (ValueError, "M must be None",
         dict(engine="sharded_fused", M=lambda z: z)),
        (ValueError, "engine=None", dict(engine="fused")),
        (ValueError, "warm start", dict(x0=torch.zeros(4096))),
        (ValueError, "engine='sharded_fused'", dict(precision="bf16")),
        (ValueError, "engine='sharded_fused'",
         dict(precision="bf16_int8wire")),
        (ValueError, "recorder", dict(recorder=[])),
        (TypeError, "unsupported kwargs",
         dict(engine="sharded_fused", block=256)),
        (TypeError, "not both", dict(engine="sharded_fused",
                                     options=SolverOptions(maxiter=3))),
        (ValueError, "rr_tau", dict(options=SolverOptions(maxiter=3,
                                                          rr_tau=1.0))),
        (ValueError, "positive ints", dict(group=(None, None))),
        (ValueError, "needs 4 ranks", dict(group=(None, (2, 2)))),
        (ValueError, "grid_shape", dict(engine="sharded_fused",
                                        group=(None, (1, 1)))),
    ]
    for exc, match, kw in cases:
        with pytest.raises(exc, match=match):
            distributed_solve(pipecg, T, b, maxiter=3, **kw) \
                if "options" not in kw else \
                distributed_solve(pipecg, T, b, **kw)
    # the int8 wire and the warm start run on the PIPECG body
    wire = distributed_solve(pipecg, T, b, engine="sharded_fused",
                             maxiter=3, precision="bf16_int8wire")
    assert torch.isfinite(wire.res_history).all()
    cold = distributed_solve(pipecg, T, b, engine="sharded_fused",
                             maxiter=3)
    warm = distributed_solve(pipecg, T, b, engine="sharded_fused",
                             maxiter=3, x0=torch.zeros(4096))
    assert torch.equal(warm.res_history, cold.res_history)
    pair = distributed_solve(pipecg, T, b, engine="sharded_fused",
                             maxiter=3, with_state=True)
    assert isinstance(pair, tuple) and len(pair) == 2
    assert sorted(pair[1]) == ["alpha_prev", "done", "gamma_prev", "p",
                               "r", "u", "x"]
    assert pair[1]["x"].shape == (1, 4096)
    # use_kernel=True runs the extended-x SpMV entry (its plain version
    # on the CPU) and gives the plain-torch route's numbers
    kernel = distributed_solve(cg, T, b, maxiter=3, use_kernel=True)
    plain = distributed_solve(cg, T, b, maxiter=3)
    assert torch.equal(kernel.res_history, plain.res_history)
    assert torch.equal(kernel.x, plain.x)
    with pytest.raises(ValueError, match="supports pipecg"):
        distributed_solve(cg, T, b, engine="sharded_fused", maxiter=3)
    from repro_torch.core.krylov.distributed import (
        sharded_pipecg_depth_solve)
    assert get_engine("sharded_fused").body("pipecg_l") is \
        sharded_pipecg_depth_solve
    # the depth body's own rejections, and the inline path's
    for exc, match, kw in (
            (ValueError, "mid-recurrence", dict(x0=torch.zeros(4096))),
            (ValueError, "int8", dict(precision="bf16_int8wire")),
            (ValueError, "M must be None", dict(M=lambda z: z)),
            (TypeError, "unsupported kwargs", dict(rr=3)),
            (ValueError, "chain reach", dict(l=3000))):
        with pytest.raises(exc, match=match):
            distributed_solve(pipecg_l, T, b, engine="sharded_fused",
                              **dict(dict(maxiter=3, l=2), **kw))
    with pytest.raises(ValueError, match="single-RHS"):
        distributed_solve(pipecg_l, T, torch.stack([b, b]),
                          engine="sharded_fused", maxiter=3, l=2)
    with pytest.raises(ValueError, match="sharded_fused"):
        distributed_solve(pipecg_l, T, b, maxiter=3, l=2)
    # the p-BiCGStab body is found now; its own rejections
    from repro_torch.core.krylov.distributed import sharded_pipebicgstab_solve
    assert get_engine("sharded_fused").body("pipebicgstab") is \
        sharded_pipebicgstab_solve
    for exc, match, kw in (
            (ValueError, "mid-recurrence", dict(x0=torch.zeros(4096))),
            (ValueError, "mid-recurrence", dict(with_state=True)),
            (ValueError, "M must be None", dict(M=lambda z: z)),
            (TypeError, "unsupported kwargs", dict(rr=3))):
        with pytest.raises(exc, match=match):
            distributed_solve(pipebicgstab, T, b, engine="sharded_fused",
                              maxiter=3, **kw)
    assert torch.isfinite(distributed_solve(
        pipebicgstab, T, b, engine="sharded_fused", maxiter=3,
        precision="bf16_int8allwire").res_history).all()
    with pytest.raises(ValueError, match="single-RHS"):
        distributed_solve(pipebicgstab, T, torch.stack([b, b]),
                          engine="sharded_fused", maxiter=3)
    with pytest.raises(ValueError, match="distributed_solve"):
        get_engine("sharded_fused").dots(b[None], b)


def test_geometry_routes_raise_as_the_reference(one_rank, monkeypatch):
    """The BSR-chain and 2-D-grid routes reject what their bodies do not
    implement, with the reference's errors."""
    from repro_torch.core.krylov.distributed import (
        sharded_pipecg_bsr_solve, sharded_pipecg_solve_2d)
    eng = get_engine("sharded_fused")
    assert eng.body("pipecg", "bsr") is sharded_pipecg_bsr_solve
    assert eng.body("pipecg", "dia2d") is sharded_pipecg_solve_2d
    with pytest.raises(ValueError, match="no sharded body"):
        eng.body("pipebicgstab", "bsr")
    Bs = _port_op("glen-bsr")
    bb = torch.from_numpy(RHS["glen-bsr"].copy())
    L = _port_op("lap2d-16x8")
    bl = torch.from_numpy(RHS["lap2d-16x8"].copy())
    grid = (None, (1, 1))
    for A, b, group in ((Bs, bb, None), (L, bl, grid)):
        for exc, match, solver, rhs, kw in (
                (ValueError, "single-RHS", pipecg, torch.stack([b, b]), {}),
                (ValueError, "pipecg only", pipecr, b, {}),
                (ValueError, "pipecg only", pipecg_multi, b, {}),
                (ValueError, "depth-1 only", pipecg, b, dict(l=2)),
                (ValueError, "solve dtype only", pipecg, b,
                 dict(precision="bf16")),
                (ValueError, "solve dtype only", pipecg, b,
                 dict(precision="bf16_int8wire")),
                (TypeError, "unsupported kwargs", pipecg, b,
                 dict(x0=torch.zeros_like(b))),
                (ValueError, "M must be None", pipecg, b,
                 dict(M=lambda z: z))):
            with pytest.raises(exc, match=match):
                distributed_solve(solver, A, rhs, group,
                                  engine="sharded_fused", maxiter=3, **kw)
    with pytest.raises(ValueError, match="chain of ranks"):
        distributed_solve(pipecg, Bs, bb, grid, engine="sharded_fused",
                          maxiter=3)
    with pytest.raises(ValueError, match="inline path"):
        distributed_solve(pipecg, Bs, bb, maxiter=3)
    # uneven block rows and an uneven grid raise before any message: seen
    # from a 3-rank group
    monkeypatch.setattr(comm, "rank_and_size", lambda group=None: (0, 3))
    with pytest.raises(ValueError, match="shard evenly"):
        distributed_solve(pipecg, Bs, bb, engine="sharded_fused",
                          maxiter=3)
    with pytest.raises(ValueError, match="tile evenly"):
        distributed_solve(pipecg, L, bl, (None, (3, 1)),
                          engine="sharded_fused", maxiter=3)


def test_one_rank_solves_in_process(one_rank):
    """A one-rank group is the single-device solve: halo strips are zero,
    the all-reduce is the identity."""
    T = _port_op("lap2d")
    b = torch.from_numpy(RHS["lap2d"].copy())
    want = pipecg(T, b, options=SolverOptions(maxiter=15, engine="naive"))
    got = distributed_solve(pipecg, T, b, engine="sharded_fused",
                            maxiter=15)
    _hist_close(want.res_history, got.res_history)
    opts = SolverOptions(maxiter=15, engine="sharded_fused",
                         precision=PrecisionPolicy())
    again = distributed_solve(pipecg, T, b, options=opts)
    assert torch.equal(again.res_history, got.res_history)
    multi = distributed_solve(pipecg_multi, T, torch.stack([b, 2 * b]),
                              engine="sharded_fused", maxiter=15)
    assert tuple(multi.x.shape) == (2, 256)
    _hist_close(got.res_history, multi.res_history[0], rtol=1e-13)
    inline = distributed_solve(pipecr, T, b, maxiter=15)
    _hist_close(pipecr(T, b, options=SolverOptions(maxiter=15)).res_history,
                inline.res_history, rtol=1e-14)
    # a (1, 1) grid runs the 2-D body, a flattened chain the inline path
    L = _port_op("lap2d-16x8")
    bl = torch.from_numpy(RHS["lap2d-16x8"].copy())
    one = pipecg(L, bl, options=SolverOptions(maxiter=15, engine="fused"))
    tile = distributed_solve(pipecg, L, bl, (None, (1, 1)),
                             engine="sharded_fused", maxiter=15)
    _hist_close(one.res_history, tile.res_history)
    flat = distributed_solve(pipecg, L, bl, (None, (1, 1)), maxiter=15)
    _hist_close(pipecg(L, bl, options=SolverOptions(maxiter=15)).res_history,
                flat.res_history, rtol=1e-14)
    Bs = _port_op("glen-bsr")
    bb = torch.from_numpy(RHS["glen-bsr"].copy())
    one = pipecg(Bs, bb, options=SolverOptions(maxiter=15, engine="fused"))
    chain = distributed_solve(pipecg, Bs, bb, engine="sharded_fused",
                              maxiter=15)
    _hist_close(one.res_history, chain.res_history, floor_rel=1e-4)
    np.testing.assert_allclose(chain.x.numpy(), one.x.numpy(), rtol=0,
                               atol=1e-10)
