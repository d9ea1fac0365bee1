"""The row-window plan of the PIPECG and p-BiCGStab sweep kernels.

``window_plan`` sizes a CTA's tile and its shared-memory windows; the
kernels (csrc/pipecg_spmv_fused.cu, csrc/pipebicgstab_fused.cu) run only
on the card, so these CPU tests hold the plan to the shared memory a CTA
may take at every shape chip_smoke.py and the card tests run, and replay
the kernels' three phases through the plan's table in plain Python
floats (float64 arithmetic, one operation at a time, as the kernels build
without FMA contraction): the vectors must equal the plain versions bit
for bit, the partials to 1e-10 of their magnitude (another summation
order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import pipebicgstab_fused as bicg
from repro_torch.kernels import pipecg_spmv_fused as pcg
from repro_torch.kernels.pipebicgstab_fused import (pipebicgstab_fused_plain,
                                                    pipebicgstab_halo_plain)
from repro_torch.kernels.pipecg_spmv_fused import (SWEEP_SMEM_LIMIT,
                                                   SWEEP_SMEM_TARGET,
                                                   SWEEP_TILE,
                                                   pipecg_spmv_fused_plain,
                                                   pipecg_spmv_halo_plain,
                                                   window_plan, window_smem,
                                                   window_table)

#: the opt-in shared memory of one CTA on the H100 (227 KB)
SMEM_OPTIN = 232_448

#: band offsets of every operator chip_smoke.py, torch_sweep_time.py and
#: the card tests hand the two sweeps
SHAPES = {
    "ex23": (-1, 0, 1),
    "lap2d-1448": (-1448, -1, 0, 1, 1448),
    "glen-21": tuple(range(-10, 11)),
    "halo-test": (-3, -1, 0, 2),
    "far-3000": (-3000, -1, 0, 1, 3000),
    "lap2d-1100": (-1100, -1, 0, 1, 1100),
    "lap2d-70": (-70, -1, 0, 1, 70),
}


SWEEPS = {"pipecg": (pcg.sweep_plan, 1, SWEEP_TILE, SWEEP_SMEM_TARGET),
          "pipebicgstab": (bicg.sweep_plan, 3, bicg.BICG_TILE,
                           bicg.BICG_SMEM_TARGET)}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
@pytest.mark.parametrize("acc_bytes", [4, 8])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_window_plan_fits_shared_memory(shape, acc_bytes, sweep):
    plan, own, max_tile, target = SWEEPS[sweep]
    tile, table, smem = plan(SHAPES[shape], acc_bytes)
    assert smem == window_smem(table, tile, own, acc_bytes)
    assert smem <= target <= SWEEP_SMEM_LIMIT < SMEM_OPTIN
    assert 32 <= tile <= max_tile and tile % 4 == 0


def test_window_plan_tiles_and_clusters():
    """ex23: one tile (1020 rows for PIPECG, 2044 for p-BiCGStab), so its
    windows fill one or two batches of SWEEP_STEP slots; the 2-D
    Laplacian's +-nx bands: five outer and three inner tile-sized
    clusters, not a +-2nx window."""
    tile, table, smem = pcg.sweep_plan(SHAPES["ex23"], 8)
    assert (tile, table[:4]) == (1020, [1, 1, 1024, 1022])
    assert smem == 16 * 6 + (1024 + 1022 + 1020) * 8
    tile, table, _ = bicg.sweep_plan(SHAPES["ex23"], 8)
    assert (tile, table[:4]) == (2044, [1, 1, 2048, 2046])
    tile, table, _ = pcg.sweep_plan(SHAPES["lap2d-1448"], 8)
    assert (tile, table[:4]) == (612, [5, 3, 5 * 612 + 8, 3 * 612 + 2])
    tile, table, _ = bicg.sweep_plan(SHAPES["lap2d-1448"], 8)
    assert (tile, table[:4]) == (1020, [5, 3, 5 * 1020 + 8, 3 * 1020 + 2])


def test_window_plan_counts_batches():
    """The chosen tile has the fewest batches per row among those within
    the target: none of its neighbours (4 rows either side) does
    better."""
    for offsets in SHAPES.values():
        tile, table, _ = pcg.sweep_plan(offsets, 8)

        def cost(t):
            tab = window_table(offsets, t)
            if window_smem(tab, t, 1, 8) > SWEEP_SMEM_TARGET:
                return float("inf")
            return (sum(-(-w // pcg.SWEEP_STEP) for w in (tab[2], tab[3], t))
                    + pcg.SWEEP_FIXED) / t
        assert all(cost(tile) <= cost(t) for t in (tile - 4, tile + 4)
                   if 32 <= t <= SWEEP_TILE)


def test_finish_groups():
    """The two-level finish: ceil(nblk / 32) groups, so ex23's 2057
    PIPECG CTAs write 2057 + 65 partial rows."""
    assert [pcg.finish_groups(b) for b in (1, 32, 33, 2057)] == [1, 1, 2, 65]
    assert pcg.FINISH_GROUP == 32


def test_window_plan_takes_32_bands_far_apart():
    """32 bands, no two within a tile of each other: 1057 outer shifts.
    The tile shrinks until the windows fit the opt-in limit."""
    offsets = tuple(int(o) for o in np.arange(-16, 16) * 5000)
    tile, table, smem = window_plan(offsets, 8, 3)
    assert smem <= SWEEP_SMEM_LIMIT
    assert table[0] == len({a + b for a in set(offsets) | {0}
                            for b in offsets} | set(offsets) | {0})


def _unpack(table, nb):
    n2, n1, w2, w1, c_own, o1, o2 = table[:7]
    cl2 = [table[8 + 3 * c:11 + 3 * c] for c in range(n2)]
    at = 8 + 3 * n2
    cl1 = [table[at + 3 * c:at + 3 + 3 * c] for c in range(n1)]
    at += 3 * n1
    dtab = [table[at + c * (nb + 1):at + (c + 1) * (nb + 1)]
            for c in range(n1)]
    wtab = table[at + n1 * (nb + 1):]
    assert len(wtab) == nb
    return n2, n1, w2, w1, c_own, o1, o2, cl2, cl1, dtab, wtab


class _Rows:
    """Row m of the operator and of a strip-extended vector, as the
    kernels read them (zero beyond what is stored)."""

    def __init__(self, n, oext, h2):
        self.n, self.oext, self.h2 = n, oext, h2

    def op(self, arr, m):
        return float(arr[m + self.oext]) if -self.oext <= m < self.n \
            + self.oext else 0.0

    def vec(self, v, lo, hi, m):
        if 0 <= m < self.n:
            return float(v[m])
        if m < 0:
            return float(lo[m + self.h2]) if lo is not None and \
                m >= -self.h2 else 0.0
        return float(hi[m - self.n]) if hi is not None and \
            m < self.n + self.h2 else 0.0


def _replay_pipecg(offsets, tile, bands, invd, csum, x, r, u, p, alpha,
                   beta, oext, strips):
    """csrc/pipecg_spmv_fused.cu's phases, one CTA after another."""
    k, n = x.shape
    nb = len(offsets)
    (n2, n1, w2, w1, c_own, o1, o2, cl2, cl1, dtab,
     wtab) = _unpack(window_table(offsets, tile), nb)
    rd = _Rows(n, oext, 0 if strips is None else strips[0].shape[-1])
    ul, uh, pl, ph = strips if strips is not None else (None,) * 4
    outs = [torch.empty_like(t) for t in (x, r, u, p)]
    red = torch.zeros(k, 6, dtype=torch.float64)
    for j in range(k):
        al, be = float(alpha[j]), float(beta[j])
        lo_hi = [None if s is None else s[j] for s in (ul, uh, pl, ph)]
        for i0 in range(0, n, tile):
            rows = min(tile, n - i0)
            P, U, R2 = [0.0] * w2, [0.0] * w1, [0.0] * tile
            for lo, w, base in cl2:
                for s in range(w):
                    m = i0 + lo + s
                    P[base + s] = (rd.vec(u[j], *lo_hi[:2], m)
                                   + be * rd.vec(p[j], *lo_hi[2:], m))
            for c, (lo, w, base) in enumerate(cl1):
                for s in range(w):
                    e, m = lo + s, i0 + lo + s
                    sv = 0.0
                    for b in range(nb):
                        sv = sv + rd.op(bands[b], m) * P[e + dtab[c][b]]
                    U[base + s] = (rd.vec(u[j], *lo_hi[:2], m)
                                   - al * (rd.op(invd, m) * sv))
                    if c == c_own and 0 <= e < rows:
                        assert base + s == o1 + e
                        p2 = P[o2 + e]
                        R2[e] = float(r[j, i0 + e]) - al * sv
                        outs[0][j, i0 + e] = float(x[j, i0 + e]) + al * p2
                        outs[1][j, i0 + e] = R2[e]
                        outs[2][j, i0 + e] = U[base + s]
                        outs[3][j, i0 + e] = p2
            for t in range(rows):
                i = i0 + t
                w2v = 0.0
                for b in range(nb):
                    w2v = w2v + float(bands[b, i + oext]) * U[t + wtab[b]]
                u2, r2 = U[o1 + t], R2[t]
                red[j] += torch.tensor([r2 * u2, w2v * u2, r2 * r2, r2 * w2v,
                                        w2v * w2v,
                                        w2v - float(csum[i]) * u2],
                                       dtype=torch.float64)
    return (*outs, red)


def _replay_bicg(offsets, tile, bands, csum, x, r, w, t, pa, a, c, rh,
                 alpha, beta, omega, oext, strips):
    """csrc/pipebicgstab_fused.cu's phases, one CTA after another."""
    (n,) = x.shape
    nb = len(offsets)
    (n2, n1, w2, w1, c_own, o1, o2, cl2, cl1, dtab,
     wtab) = _unpack(window_table(offsets, tile), nb)
    rd = _Rows(n, oext, 0 if strips is None else strips[0].shape[-1])
    wl, wh, tl, th, cl_, ch = strips if strips is not None else (None,) * 6
    al, be, om = float(alpha), float(beta), float(omega)
    outs = [torch.empty_like(v) for v in (x, r, w, t, pa, a, c)]
    basis = torch.zeros(6, n, dtype=torch.float64)
    chk = 0.0
    for i0 in range(0, n, tile):
        rows = min(tile, n - i0)
        Z, W = [0.0] * w2, [0.0] * w1
        for lo, width, base in cl2:
            for s in range(width):
                m = i0 + lo + s
                Z[base + s] = (rd.vec(t, tl, th, m)
                               + be * rd.vec(c, cl_, ch, m))
        for cc, (lo, width, base) in enumerate(cl1):
            for s in range(width):
                e, m = lo + s, i0 + lo + s
                v = 0.0
                for b in range(nb):
                    v = v + rd.op(bands[b], m) * Z[e + dtab[cc][b]]
                z = Z[e + dtab[cc][nb]]
                y = rd.vec(w, wl, wh, m) - al * z
                W[base + s] = y - om * (rd.vec(t, tl, th, m) - al * v)
                if cc == c_own and 0 <= e < rows:
                    assert z == Z[o2 + e] and base + s == o1 + e
                    ri, wi = float(r[m]), float(w[m])
                    pv = ri + be * float(pa[m])
                    sv = wi + be * float(a[m])
                    q = ri - al * sv
                    vals = (float(x[m]) + al * pv + om * q, q - om * y,
                            W[base + s], pv - om * sv, sv - om * z,
                            z - om * v)
                    for o, val in zip(outs[:3] + outs[4:], vals):
                        o[m] = val
        for tt in range(rows):
            i = i0 + tt
            t2 = 0.0
            for b in range(nb):
                t2 = t2 + float(bands[b, i + oext]) * W[tt + wtab[b]]
            outs[3][i] = t2
            basis[:, i] = torch.tensor([float(outs[1][i]), W[o1 + tt], t2,
                                        float(outs[5][i]), float(outs[6][i]),
                                        float(rh[i])], dtype=torch.float64)
            chk += t2 - float(csum[i]) * W[o1 + tt]
    gram = torch.cat([basis @ basis.T, torch.zeros(1, 6, dtype=torch.float64)])
    gram[6, 0] = chk
    return (*outs, gram)


def _rel(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


REPLAYS = [  # (offsets, n, tile, halo)
    ((-1, 0, 1), 37, 8, False),
    ((-1, 0, 1), 37, 8, True),
    ((-1, 0, 1), 5, 16, False),
    ((-7, -1, 0, 1, 7), 50, 4, False),
    ((-7, -1, 0, 1, 7), 50, 4, True),
    ((-3, -1, 0, 2), 23, 16, True),
    ((2, 5), 19, 4, False),
    ((-30, 30), 19, 4, True),
    (tuple(range(-3, 4)), 41, 8, False),
]


@pytest.mark.parametrize("offsets,n,tile,halo", REPLAYS)
def test_window_table_replays_pipecg_sweep(offsets, n, tile, halo):
    """Tiles of 4-16 rows force far bands into clusters of their own,
    ragged ends and rows beyond a rank's strips."""
    g = np.random.default_rng(n + tile)
    h = max(abs(o) for o in offsets)
    ext = h if halo else 0
    k = 2

    def rnd(*shape):
        return torch.from_numpy(g.standard_normal(shape))

    bands, invd, csum = rnd(len(offsets), n + 2 * ext), rnd(n + 2 * ext), \
        rnd(n)
    x, r, u, p = (rnd(k, n) for _ in range(4))
    a, b = torch.from_numpy(g.random(k)), torch.from_numpy(g.random(k))
    strips = [rnd(k, 2 * h) for _ in range(4)] if halo else None
    if halo:
        want = pipecg_spmv_halo_plain(offsets, bands, invd, csum, x, r, u, p,
                                      *strips, a, b)
    else:
        want = pipecg_spmv_fused_plain(offsets, bands, invd, csum, x, r, u,
                                       p, a, b)
    got = _replay_pipecg(offsets, tile, bands, invd, csum, x, r, u, p, a, b,
                         ext, strips)
    for gv, wv in zip(got[:4], want[:4]):
        assert torch.equal(gv, wv)
    assert _rel(got[4], want[4]) <= 1e-10


@pytest.mark.parametrize("offsets,n,tile,halo", REPLAYS)
def test_window_table_replays_pipebicgstab_sweep(offsets, n, tile, halo):
    g = np.random.default_rng(2 * n + tile)
    h = max(abs(o) for o in offsets)
    ext = h if halo else 0

    def rnd(*shape):
        return torch.from_numpy(g.standard_normal(shape))

    bands, csum, x = rnd(len(offsets), n + 2 * ext), rnd(n), rnd(n)
    chains = [rnd(n) for _ in range(7)]
    sc = [torch.tensor(float(v), dtype=torch.float64) for v in g.random(3)]
    strips = [rnd(2 * h) for _ in range(6)] if halo else None
    if halo:
        want = pipebicgstab_halo_plain(offsets, bands, csum, x, *chains,
                                       *strips, *sc)
    else:
        want = pipebicgstab_fused_plain(offsets, bands, csum, x, *chains,
                                        *sc)
    got = _replay_bicg(offsets, tile, bands, csum, x, *chains, *sc, ext,
                       strips)
    for gv, wv in zip(got[:7], want[:7]):
        assert torch.equal(gv, wv)
    assert _rel(got[7], want[7]) <= 1e-10


def test_plans_are_built_once(monkeypatch):
    """The device table is built once per sweep, operator and dtype; the
    wrapper reuses it (a CPU device stands in for the card here)."""
    monkeypatch.setattr(pcg, "_PLANS", {})
    cpu = torch.device("cpu")
    first = pcg.device_plan(pcg.sweep_plan, (-1, 0, 1), 8, cpu)
    again = pcg.device_plan(pcg.sweep_plan, [-1, 0, 1], 8, cpu)
    assert first[1] is again[1] and first[1].dtype == torch.int32
    assert first[1].tolist() == window_table((-1, 0, 1), first[0])
    other = pcg.device_plan(bicg.sweep_plan, (-1, 0, 1), 8, cpu)
    assert other[0] != first[0] and other[1] is not first[1]
