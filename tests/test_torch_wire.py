"""The int8 halo/Gram wire on the port's sharded PIPECG and p-BiCGStab
bodies, on gloo CPU ranks, against the JAX package.

The problems are the JAX package's precision stage's
(repro/experiments/precision_exec.py): the pentadiagonal band with halo
128 and a Gaussian right-hand side for PIPECG (the stage's 300
iterations), the shifted tridiagonal Laplacian with b = ones for
p-BiCGStab (40 iterations here: past its convergence, while the stage's
450 run on the card), at the stage's n = 1024, under the five policies
of its spec.  One spawn per
world size (4 and 2 ranks) runs every cell; one JAX subprocess with 4
forced host devices runs the JAX sharded bodies with their Pallas sweeps
replaced by the kernels' arithmetic in jnp (tests/jax_slice_reference.py,
H1) over the first WINDOW iterations of every cell.

Held: histories to rtol 1e-10 over the H6 window (the first 12
iterations under bf16 storage, 30 in float64, above 1e-4 of the first
residual); the stage's own classification
(``precision_exec._classify``) of the PIPECG cells (safe within
``FLOOR_FACTORS x storage_eps``, no-EF at least 1.05x its EF partner, the
int8 Gram outside the floor); the split-phase order with one reduction
a iteration on every rank; and the bytes each rank hands ``comm``: under
``wire='int8'`` every strip goes as int8 (4 scale bytes + 2h payload
bytes a strip), the full-width strips of the other policies as their
storage dtype.

p-BiCGStab's plateau after 450 forced iterations is the drift of x past
convergence (ROADMAP.md queue 3, H8): the JAX body on the same
arithmetic lands at 102.9 eps_fp32 under ``fp32`` at 4 ranks, outside
its own floor of 32, so the p-BiCGStab cells are held to finite
plateaus and to the reference's history, not to the floor (H13).
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest
import torch

import jax_slice_reference as R
from repro.experiments import precision_exec as stage
from repro_torch.core.krylov import PrecisionPolicy
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.distributed import ranks

N = 1024
SEED = 1          # the stage's rng(spec.seed + 1), spec.seed = 0
POLICIES = ("fp32", "bf16", "bf16_int8wire", "bf16_int8wire_noef",
            "bf16_int8allwire")
# PIPECG at the spec's precision_maxiter, where the stage classifies it;
# p-BiCGStab, which the stage does not classify here (H13), through the
# H6 window and past its convergence only (chip_smoke.py runs the stage's
# 450 at full size)
ITERS = {"pipecg": 300, "pipebicgstab": 40}
SOLVERS = tuple(ITERS)
WORLDS = (4, 2)


def _window(policy):
    return 30 if policy == "fp32" else 12


def _problem(problem):
    offs, bands = R.precision_problems(N)[problem]
    b = (np.random.default_rng(SEED).standard_normal(N)
         if problem == "pipecg" else np.ones(N))
    return offs, bands, b


def _cells():
    return [(s, p) for s in SOLVERS for p in POLICIES]


# the problem of each solver's H9 cell under bf16: the stage's
# p-BiCGStab bands are exact in bf16, so it gets a variant that rounds,
# run after the stage's cells
H9_PROBLEMS = {"pipecg": "pipecg", "pipebicgstab": "pipebicgstab-rounded"}


def _h9_index(solver):
    """Index of ``solver``'s H9 cell among the port's cases."""
    if solver == "pipecg":
        return _cells().index(("pipecg", "bf16"))
    return len(_cells())


def _port_cases():
    out = []
    cells = [(s, s, p) for s, p in _cells()]
    cells.append(("pipebicgstab", H9_PROBLEMS["pipebicgstab"], "bf16"))
    for solver, problem, policy in cells:
        offs, bands, b = _problem(problem)
        out.append(dict(solver=solver,
                        A=DiaMatrix(offsets=offs,
                                    bands=torch.from_numpy(bands.copy())),
                        b=torch.from_numpy(b.copy()),
                        kw=dict(engine="sharded_fused",
                                maxiter=ITERS[solver], precision=policy)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("wire") / "ref.pkl")
    wire = [dict(solver=s, policy=p, world=w, maxiter=_window(p))
            for w in WORLDS for s, p in _cells()]
    wire += [dict(solver="pipebicgstab",
                  problem=H9_PROBLEMS["pipebicgstab"], policy="bf16",
                  world=w, maxiter=_window("bf16")) for w in WORLDS]
    cfg = dict(devices=4, n=N, seed=SEED, out=out, elastic=[], wire=wire)
    proc = R.start(cfg)
    try:
        port = {w: ranks.run(ranks.solve_cases, w, _port_cases(), "cpu",
                             device="cpu") for w in WORLDS}
    except BaseException:
        proc.kill()
        raise
    return port, R.finish(proc, out)


def _true_rel(solver, x):
    offs, bands, b = _problem(solver)
    return stage._true_residual(offs, bands, x, b)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("cell", [f"{s}/{p}" for s, p in _cells()])
def test_wire_history_matches_the_jax_body(runs, world, cell):
    port, ref = runs
    solver, policy = cell.split("/")
    i = _cells().index((solver, policy))
    want = ref[f"wire/{solver}/{policy}/{world}"]["res_history"]
    # H6: rtol 1e-10 holds while the residual stays above 1e-4 of its
    # start; the int8 Gram freezes p-BiCGStab at once, on a zero norm
    held = want > 1e-4 * want[0] if want[0] > 0 else want == 0
    assert held.sum() >= 6
    for rank_out in port[world]:
        got = rank_out[i]["res_history"][:want.size]
        np.testing.assert_allclose(got[held], want[held], rtol=1e-10)
        assert np.all(np.isfinite(rank_out[i]["x"]))
        assert rank_out[i]["order_ok"] is True
        # one reduction per iteration and the set-up's (H5)
        assert rank_out[i]["reductions"] == ITERS[solver] + 1
        assert rank_out[i]["all_reduces"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_precision_stage_classification(runs, world):
    """The stage's own verdicts on the port's PIPECG cells."""
    port, _ = runs
    cells = []
    for solver, policy in _cells():
        if solver != "pipecg":
            continue
        x = port[world][0][_cells().index((solver, policy))]["x"]
        eps = PrecisionPolicy.from_name(policy).storage_eps
        true_res = _true_rel(solver, x)
        floor = stage.FLOOR_FACTORS[solver] * eps
        expect = ("safe" if policy in stage.SAFE_POLICIES[solver]
                  else "degraded" if policy in
                  stage.DEGRADED_POLICIES[solver] else "unsafe")
        cells.append(dict(solver=solver, policy=policy, expect=expect,
                          true_res_rel=true_res, within_floor=bool(
                              true_res <= floor)))
    stage._classify(cells)
    verdicts = {c["policy"]: (c["expect"], c["precision_ok"]) for c in cells}
    assert all(ok for _, ok in verdicts.values()), verdicts
    assert verdicts["bf16_int8allwire"][0] == "unsafe"
    assert verdicts["bf16_int8wire_noef"][0] == "degraded"


@pytest.mark.parametrize("world", WORLDS)
def test_pipebicgstab_wire_plateaus_are_finite(runs, world):
    port, _ = runs
    for policy in POLICIES:
        x = port[world][0][_cells().index(("pipebicgstab", policy))]["x"]
        assert np.all(np.isfinite(x))
        assert _true_rel("pipebicgstab", x) < 1.0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_halo_payload_is_int8_under_the_wire(runs, world, solver):
    """Bytes each rank hands ``comm`` a solve, by dtype.  Per iteration
    each exchanged vector (u, p; or w, t, c) sends one strip to each
    chain neighbour: 4 + 2h int8 bytes on the int8 wire, 2h storage
    words otherwise; the set-up's exchanges (operator, diag^-1, the
    initial SpMVs) go as float64."""
    port, _ = runs
    offs = R.precision_problems(N)[solver][0]
    h = max(abs(o) for o in offs)
    nvec = 2 if solver == "pipecg" else 3
    it = ITERS[solver]
    for rank, rank_out in enumerate(port[world]):
        peers = (rank > 0) + (rank < world - 1)
        # the bands, diag^-1 or a second set-up SpMV, and one SpMV
        setup = (len(offs) + 2) * h * 8 * peers
        for policy in POLICIES:
            got = rank_out[_cells().index((solver, policy))]["wire_bytes"]
            pol = PrecisionPolicy.from_name(policy)
            strips = it * nvec * peers
            if pol.wire == "int8":
                want = {"float64": setup, "int8": strips * (4 + 2 * h)}
            elif pol.storage == "bf16":
                want = {"float64": setup, "bfloat16": strips * 2 * h * 2}
            else:
                want = {"float64": setup + strips * 2 * h * 8}
            assert got == want, (policy, rank)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_h9_checksum_row_checks_the_streamed_operator(runs, world, solver):
    """H9, decided: under bf16 storage the sweeps' column sums are those
    of the demoted operator, summed at bf16 as the JAX halo wrappers sum
    them.  The pentadiagonal band's 4.1 rounds to 4.09375 in bf16, and
    p-BiCGStab's cell runs the tridiagonal with 3.1 (3.09375 in bf16:
    the stage's -1 and 3 are exact there), so a c taken from the
    full-precision operator would leave (c - c_bf16)^T u' in the row; in
    both packages the row stays at rounding level."""
    port, ref = runs
    problem = H9_PROBLEMS[solver]
    offs, bands, _ = _problem(problem)
    demoted = torch.from_numpy(bands).to(torch.bfloat16).double().numpy()
    assert not np.array_equal(demoted, bands)
    i = _h9_index(solver)
    want = ref[f"wire/{problem}/bf16/{world}"]["detect_history"]
    assert np.abs(want).max() < 1e-9
    for rank_out in port[world]:
        got = rank_out[i]["detect_history"]
        assert got.shape == (ITERS[solver],)
        assert np.abs(got).max() < 1e-9
