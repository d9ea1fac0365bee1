"""The plan and the passes of the depth-l ghost-chain sweep kernel.

``chain_plan`` sizes a chain CTA's tile and its link workspace; the
kernel (csrc/ghost_chain.cu) runs only on the card, so these CPU tests
hold the plan to the shared memory a CTA may take at every shape
chip_smoke.py, torch_sweep_time.py and the card tests hand the sweep, and
replay the kernel in plain Python floats (one operation at a time, as the
kernel builds without FMA contraction): both chains per pass over the
window slots each thread owns, batch by batch, the links in the
workspace layout the kernel indexes, each thread's Gram products over its
own rows, the CTA's butterfly reduction of each pair group and the
two-level finish (common.cuh's shuffle trees).  The chains must equal the
plain versions bit for bit, the Gram to 1e-12 of its terms' magnitudes
(another summation order).
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest
import torch

from repro_torch.kernels import pipecg_spmv_fused as pcg
from repro_torch.kernels.pipecg_spmv_fused import (CHAIN_GRAM_GROUP,
                                                   SWEEP_SMEM_LIMIT,
                                                   SWEEP_STEP, chain_plan,
                                                   chain_words,
                                                   ghost_chain_fused_plain,
                                                   ghost_chain_halo_plain)

#: the opt-in shared memory of one CTA on the H100 (227 KB)
SMEM_OPTIN = 232_448
BLOCK, BATCH = 256, 4  # kBlock, kBatch of csrc/common.cuh

#: (halo h, depths) of every operator chip_smoke.py, torch_sweep_time.py
#: and the card tests hand the chain sweep
SHAPES = {
    "ex23": (1, (1, 2, 4, 8)),
    "lap2d-1448": (1448, (2, 4)),
    "glen-21": (10, (1, 2, 4, 8)),
    "lap2d-70x50": (70, (1, 2, 4, 8)),
    "halo-test": (3, (2,)),
}
CASES = [(name, h, l) for name, (h, ls) in SHAPES.items() for l in ls]


@pytest.mark.parametrize("acc_bytes", [4, 8])
@pytest.mark.parametrize("name,h,l", CASES)
def test_chain_plan_fits_or_takes_the_global_workspace(name, h, l,
                                                       acc_bytes):
    """Whole batches; shared memory within the opt-in limit, else the
    global scratch; the words the kernel checks for."""
    reach, m = l * h, 2 * l + 1
    tile, ws, shared = chain_plan(reach, m, acc_bytes)
    assert (tile + 2 * reach) % SWEEP_STEP == 0
    assert ws == chain_words(tile, reach, m) == m * tile + 2 * l * l * h
    if shared:
        assert ws * acc_bytes <= SWEEP_SMEM_LIMIT < SMEM_OPTIN
    else:
        assert chain_words(SWEEP_STEP - 2 * reach % SWEEP_STEP, reach, m) \
            * acc_bytes > SWEEP_SMEM_LIMIT
        assert tile <= pcg.CHAIN_MAX_TILE


def test_chain_plan_takes_one_batch_for_narrow_reaches():
    """ex23 at l = 2 and 4: one 1024-slot batch (1020 and 1016 rows), the
    windows the kernel's register path takes; laplacian_2d(1448, 1448) at
    l = 2 fits shared memory in 2400-row tiles, at l = 4 in float64 it
    takes the global scratch."""
    assert chain_plan(2, 5, 8) == (1020, 5 * 1020 + 8, True)
    assert chain_plan(4, 9, 8) == (1016, 9 * 1016 + 32, True)
    assert chain_plan(2, 5, 4)[0] == 1020
    assert chain_plan(2 * 1448, 5, 8) == (2400, 5 * 2400 + 8 * 1448, True)
    assert chain_plan(4 * 1448, 9, 8)[2] is False


# -- the replay --------------------------------------------------------------

def _link_base(c, l, h, tile):
    """csrc/ghost_chain.cu::link_base."""
    pc = c <= l
    j = c if pc else c - l - 1
    depth = l if pc else l - 1
    before = 0 if pc else (l + 1) * tile + h * l * (l + 1)
    off = before + j * tile + 2 * h * (j * depth - j * (j - 1) // 2)
    return off - (l - (depth - j)) * h


def _tree(x):
    """Lane 0 of a warp's ``__shfl_down_sync`` tree over 32 values (a
    lane past the warp reads its own value)."""
    x = list(x)
    for o in (16, 8, 4, 2, 1):
        x = [x[i] + (x[i + o] if i + o < 32 else x[i]) for i in range(32)]
    return x[0]


def _gram_row(vals):
    """csrc/ghost_chain.cu::gram_row for one column: each warp's butterfly
    (lane offsets 16, 8, 4, 2, 1), then the warps in order."""
    warps = []
    for w in range(0, len(vals), 32):
        x = list(vals[w:w + 32])
        for o in (16, 8, 4, 2, 1):
            x = [x[i] + x[i ^ o] for i in range(32)]
        warps.append(x[0])
    total = warps[0]
    for v in warps[1:]:
        total = total + v
    return total


def _block_reduce(vals, zero):
    """common.cuh::block_reduce over one value a thread."""
    warps = [_tree(vals[w:w + 32]) for w in range(0, len(vals), 32)]
    return _tree(warps + [zero] * (32 - len(warps)))


def _sum_rows(rows, zero):
    """common.cuh::sum_rows for rows of more than 8 columns."""
    nc = len(rows[0])
    if len(rows) <= 32:
        return [_tree([r[c] for r in rows] + [zero] * (32 - len(rows)))
                for c in range(nc)]
    out = []
    for c in range(nc):
        per = []
        for t in range(BLOCK):
            v = zero
            for b in range(t, len(rows), BLOCK):
                v = v + rows[b][c]
            per.append(v)
        out.append(_block_reduce(per, zero))
    return out


def _finish(rows, zero):
    """common.cuh::finish_rows, the two-level order of wide rows."""
    groups = [_sum_rows(rows[g:g + 32], zero) for g in range(0, len(rows),
                                                              32)]
    return _sum_rows(groups, zero)


def _replay(offsets, bands, p, r, strips, th_inv, l, tile, oext, n_valid,
            num):
    """csrc/ghost_chain.cu's passes, one CTA after another, in ``num``
    (float or np.float32) arithmetic.  Returns (C at ``num``, Gram)."""
    n, nb = len(p), len(offsets)
    h = max(abs(o) for o in offsets)
    H, m = l * h, 2 * l + 1
    W = tile + 2 * H
    step = BLOCK * BATCH
    nbat = -(-W // step)
    zero, thi = num(0), num(th_inv)
    p_lo, p_hi, r_lo, r_hi = strips if strips is not None else (None,) * 4

    def vec(v, lo, hi, g):
        if 0 <= g < n:
            return num(v[g])
        if g < 0:
            return num(lo[g + H]) if lo is not None and g >= -H else zero
        return num(hi[g - n]) if hi is not None and g < n + H else zero

    def band(k, g):
        return num(bands[k][g + oext]) if -oext <= g < n + oext else zero

    def owned(tid):
        return [b * step + q * BLOCK + tid for b in range(nbat)
                for q in range(BATCH)]

    C = [[zero] * n for _ in range(m)]
    npairs = m * (m + 1) // 2
    ngr = -(-npairs // CHAIN_GRAM_GROUP)
    parts = [[] for _ in range(ngr)]
    for i0 in range(0, n, tile):
        rows = min(tile, n - i0)
        g0 = i0 - H
        ws = {}
        for tid in range(BLOCK):                      # pass 0
            for s in owned(tid):
                if s < W:
                    ws[_link_base(0, l, h, tile) + s] = vec(p, p_lo, p_hi,
                                                            g0 + s)
                    if 0 <= s - H < rows:
                        C[0][i0 + s - H] = ws[_link_base(0, l, h, tile) + s]
                if h <= s < W - h:
                    ws[_link_base(l + 1, l, h, tile) + s] = vec(r, r_lo, r_hi,
                                                                g0 + s)
                    if 0 <= s - H < rows:
                        C[l + 1][i0 + s - H] = ws[_link_base(l + 1, l, h,
                                                             tile) + s]
        for j in range(1, l + 1):                     # pass j
            for c_prev, c_new, e in ((j - 1, j, j * h),
                                     (l + j, l + 1 + j, (j + 1) * h)):
                if c_new == l + 1 + j and j == l:
                    continue
                bp = _link_base(c_prev, l, h, tile)
                bn = _link_base(c_new, l, h, tile)
                for tid in range(BLOCK):
                    for s in owned(tid):
                        if not e <= s < W - e:
                            continue
                        acc = zero
                        for k, o in enumerate(offsets):
                            acc = acc + band(k, g0 + s) * ws[bp + s + o]
                        ws[bn + s] = acc * thi
                        if 0 <= s - H < rows:
                            C[c_new][i0 + s - H] = ws[bn + s]
        nv = max(0, min(tile, n_valid - i0))
        pairs = [(a, b) for a in range(m) for b in range(a, m)]
        for gi in range(ngr):
            grp = pairs[gi * CHAIN_GRAM_GROUP:(gi + 1) * CHAIN_GRAM_GROUP]
            per = [[zero] * CHAIN_GRAM_GROUP for _ in range(BLOCK)]
            for tid in range(BLOCK):
                for s in owned(tid):
                    if not 0 <= s - H < nv:
                        continue
                    for c, (a, b) in enumerate(grp):
                        per[tid][c] = per[tid][c] + (
                            ws[_link_base(a, l, h, tile) + s]
                            * ws[_link_base(b, l, h, tile) + s])
            parts[gi].append([_gram_row([per[t][c] for t in range(BLOCK)])
                              for c in range(CHAIN_GRAM_GROUP)])
    gram = np.zeros((m, m))
    for gi in range(ngr):
        v = _finish(parts[gi], zero)
        for c, (a, b) in enumerate([(a, b) for a in range(m)
                                    for b in range(a, m)]
                                   [gi * CHAIN_GRAM_GROUP:]
                                   [:CHAIN_GRAM_GROUP]):
            gram[a, b] = gram[b, a] = float(v[c])
    return np.array(C, dtype=float), gram


def _gram_rel(got, want, C):
    mags = np.abs(C) @ np.abs(C).T
    return float((np.abs(got - want) / np.maximum(mags, 1e-300)).max())


REPLAYS = [  # (offsets, n, l, tile or None for the plan's, halo, float32)
    ((-1, 0, 1), 2500, 2, None, False, False),
    ((-1, 0, 1), 1500, 4, None, True, False),
    ((-1, 0, 1), 2100, 2, None, False, True),
    ((-1, 0, 1), 150, 1, 4, False, False),        # 38 CTAs: two groups
    ((-1, 0, 1), 70, 8, 8, True, False),          # 11 pair groups
    ((-3, -1, 0, 2), 1300, 2, None, True, False),
    ((-300, -1, 0, 1, 300), 5300, 2, None, False, False),  # 6 batches
    ((-40, -1, 0, 1, 40), 900, 3, 200, True, True),
    ((2, 5), 333, 2, 64, False, False),
]


@pytest.mark.parametrize("offsets,n,l,tile,halo,f32", REPLAYS)
def test_replay_of_the_passes_matches_the_plain_chain(offsets, n, l, tile,
                                                      halo, f32):
    """Ragged n; the plan's tiles (one batch, six batches) and small
    tiles that force many CTAs (the two-level finish) and many pair
    groups; rows past the strips read as zero; float32 rounds each
    operation as the kernel does."""
    g = np.random.default_rng(n + l)
    h = max(abs(o) for o in offsets)
    H = l * h
    dt = torch.float32 if f32 else torch.float64
    num = np.float32 if f32 else float
    if tile is None:
        tile = chain_plan(H, 2 * l + 1, 4 if f32 else 8)[0]

    def rnd(*shape):
        return torch.from_numpy(g.standard_normal(shape)).to(dt)

    p, r = rnd(n), rnd(n)
    theta = 2.7
    if halo:
        bands = rnd(len(offsets), n + 2 * H)
        strips = [rnd(H) for _ in range(4)]
        want = ghost_chain_halo_plain(offsets, bands, p, r, *strips, theta,
                                      l)
        oext = H
    else:
        bands, strips = rnd(len(offsets), n), None
        want = ghost_chain_fused_plain(offsets, bands, p, r, theta, l)
        oext = 0
    th_inv = float(pcg._theta_inv(theta, dt, torch.device("cpu")))
    lists = [t.tolist() for t in strips] if strips is not None else None
    C, G = _replay(offsets, bands.tolist(), p.tolist(), r.tolist(), lists,
                   th_inv, l, tile, oext, n, num)
    assert torch.equal(torch.from_numpy(C).to(dt), want[0])
    assert _gram_rel(G, want[1].double().numpy(), C) <= \
        (1e-6 if f32 else 1e-12)


def test_replay_masks_rows_past_n_valid():
    """Rows >= n_valid stay out of the Gram, the chain is unchanged."""
    g = np.random.default_rng(5)
    n, nv, l, offsets = 700, 555, 2, (-1, 0, 1)
    p, r = (torch.from_numpy(g.standard_normal(n)) for _ in range(2))
    bands = torch.from_numpy(g.standard_normal((3, n)))
    C, G = _replay(offsets, bands.tolist(), p.tolist(), r.tolist(), None,
                   1 / 2.7, l, 256, 0, nv, float)
    Cw, _ = ghost_chain_fused_plain(offsets, bands, p, r, 2.7, l)
    assert torch.equal(torch.from_numpy(C), Cw)
    Cv = Cw[:, :nv]
    assert _gram_rel(G, (Cv @ Cv.T).numpy(), Cv.numpy()) <= 1e-12


def test_link_layout_is_dense_and_disjoint():
    """Every link's slots map to distinct workspace words, all within
    chain_words, with no gap: link j of p over [j h, W - j h), of r over
    [(j+1) h, W - (j+1) h)."""
    for h, l, tile in ((1, 2, 1020), (3, 1, 40), (70, 8, 928), (0, 3, 9)):
        m, H = 2 * l + 1, l * h
        W = tile + 2 * H
        used = []
        for c in range(m):
            j, e0 = (c, c * h) if c <= l else (c - l - 1, (c - l) * h)
            used += [_link_base(c, l, h, tile) + s for s in range(e0, W - e0)]
        assert sorted(used) == list(range(chain_words(tile, H, m)))
