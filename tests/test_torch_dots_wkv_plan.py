"""Launch plans of the ``wkv_recurrent`` and ``fused_dots`` kernels, on the CPU.

Both kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there).  Here their launch plans are checked
against the constants of the CUDA sources, against shared memory and the
two-CTAs-an-SM target, and replayed in numpy: the wkv kernel's split of
the state into row slices and column blocks, its reduce-scatter
butterfly and the lanes that store each column; the dots kernel's
columns a CTA and thread, and its one-launch finish.  Each replay is held
against the plain torch version on the same numpy inputs.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import fused_dots as fd
from repro_torch.kernels import wkv

#: shared memory an SM holds for resident CTAs (228 KB), the most one CTA
#: may opt into (227 KB), and what the runtime reserves a CTA
SM_SMEM = 233_472
CTA_SMEM = 232_448
CTA_RESERVED = 1024


def _constants(name):
    src = (build.CSRC / name).read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}, src


def test_wkv_constants_are_the_kernels():
    consts, src = _constants("wkv.cu")
    assert consts["kWkvChunk"] == wkv.CHUNK
    assert consts["kWkvStages"] == wkv.STAGES
    # each head dim's WkvShape<D, rows, cols, split> against the plan
    shapes = re.findall(r"WkvPlan<(\d+)>\s*\{\s*using type =\s*"
                        r"WkvShape<(\d+),\s*(\d+),\s*(\d+),\s*(\d+)>", src)
    assert sorted(int(d) for d, *_ in shapes) == list(wkv.HEAD_DIMS)
    for d, d2, rows, cols, split in shapes:
        assert d == d2
        plan = wkv.wkv_plan(int(d), torch.float32)
        assert (plan["rows"], plan["cols"], plan["split"]) == (
            int(rows), int(cols), int(split)) == wkv.SHAPES[int(d)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", wkv.HEAD_DIMS)
def test_wkv_plan_fits_two_ctas_an_sm(D, dtype):
    p = wkv.wkv_plan(D, dtype)
    assert p["threads"] % 32 == 0 and p["threads"] <= 1024
    assert p["slices"] * p["rows"] == D and p["rows"] % 4 == 0
    assert p["slices"] <= 32 and 32 % p["slices"] == 0
    assert p["threads"] == p["slices"] * (D // p["split"]) // p["cols"]
    # the bonus takes threads // chunk threads a step, four values at a time
    assert p["threads"] % p["chunk"] == 0
    tps = p["threads"] // p["chunk"]
    assert tps <= 32 and (D // tps) % 4 == 0
    # each chunk's rows are whole 16-byte bulk copies
    assert D * torch.empty((), dtype=dtype).element_size() % 16 == 0
    assert p["smem"] + 16 <= CTA_SMEM
    assert 2 * (p["smem"] + 16 + CTA_RESERVED) <= SM_SMEM
    assert p["stages"] == 2
    assert p["chunk"] == (16 if D == 128 else 32)


def test_wkv_plan_rejects_other_head_dims():
    with pytest.raises(ValueError, match="head dim"):
        wkv.wkv_plan(48, torch.float32)


def _reduce_cols(a, nsl):
    """The kernel's reduce_cols on a (lanes, C) array of one column group's
    slice partials: the same halves kept and sent at each mask."""
    a = a.copy()
    nv, m = a.shape[1], nsl // 2
    while m >= 1:
        lanes = np.arange(nsl)
        partner = lanes ^ m
        if nv > 1:
            h = nv // 2
            hi = (lanes & m) != 0
            send = np.where(hi[:, None], a[:, :h], a[:, h:nv])
            keep = np.where(hi[:, None], a[:, h:nv], a[:, :h])
            a = np.concatenate([keep + send[partner], a[:, h:]], axis=1)
            nv = h
        else:
            a[:, 0] = a[:, 0] + a[partner, 0]
        m //= 2
    return a


def _wkv_replay(r, k, v, logw, u):
    """The kernel's arithmetic a step at a time over its thread blocks."""
    BH, T, D = r.shape
    p = wkv.wkv_plan(D, torch.float32)
    R, Cc, nsl, split = p["rows"], p["cols"], p["slices"], p["split"]
    cols_cta = D // split
    n_out = max(Cc // nsl, 1)
    share = max(nsl // Cc, 1)
    f = np.float32
    o = np.full((BH, T, D), np.nan, f)
    for bh in range(BH):
        S = np.zeros((D, D), f)
        w = np.exp(logw[bh].astype(f))
        for t in range(T):
            # the bonus: tps threads a step, each over part consecutive i
            # in four partial sums, then a pairwise tree over the threads
            tps = p["threads"] // p["chunk"]
            part = D // tps
            sums = []
            for g in range(tps):
                b = np.zeros(4, f)
                for j in range(0, part, 4):
                    for q in range(4):
                        i = g * part + j + q
                        b[q] += f(r[bh, t, i] * u[bh, i]) * k[bh, t, i]
                sums.append((b[0] + b[1]) + (b[2] + b[3]))
            while len(sums) > 1:
                sums = [sums[a] + sums[a + 1] for a in range(0, len(sums), 2)]
            bonus = sums[0]
            for y in range(split):
                for cg in range(cols_cta // Cc):
                    col = y * cols_cta + cg * Cc
                    part = np.zeros((nsl, Cc), f)
                    for s in range(nsl):
                        rows = [4 * (s + nsl * q) + e for q in range(R // 4)
                                for e in range(4)]
                        for i in rows:
                            part[s] += r[bh, t, i] * S[i, col:col + Cc]
                    red = _reduce_cols(part, nsl)
                    for s in range(0, nsl, share):
                        mine = col + (s // share) * n_out
                        for q in range(n_out):
                            assert np.isnan(o[bh, t, mine + q])
                            o[bh, t, mine + q] = (red[s, q]
                                                  + bonus * v[bh, t, mine + q])
            S = w[t][:, None] * S + k[bh, t][:, None] * v[bh, t][None, :]
    return o


@pytest.mark.parametrize("D,T", [(16, 5), (32, 3), (64, 3), (128, 2)])
def test_wkv_replay_matches_the_plain_version(D, T):
    """Every column of every step stored once, by the lane the butterfly
    leaves it in, and the sums those of the recurrence."""
    rng = np.random.default_rng(D + T)
    r, k, v = (rng.standard_normal((2, T, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((2, T, D)) - 2.0).astype(np.float32)
    u = (0.3 * rng.standard_normal((2, D))).astype(np.float32)
    got = _wkv_replay(r, k, v, logw, u)
    want = wkv.wkv_recurrent_plain(*(torch.from_numpy(x)
                                     for x in (r, k, v, logw, u))).numpy()
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_dots_constants_are_the_kernels():
    consts, src = _constants("fused_dots.cu")
    assert consts["kDotsMaxBlocks"] == fd.MAX_BLOCKS
    assert consts["kDotsVecBytes"] == fd.VEC_BYTES
    items = sorted(int(c) for c in re.findall(
        r"case (\d+): return go\(fused_dots_kernel", src))
    assert tuple(items) == fd.ITEMS
    rows = sorted(int(c) for c in re.findall(
        r"case (\d+):\s*return launch_dots", src))
    assert tuple(rows) == fd.ROWS


@pytest.mark.parametrize("itemsize", [8, 4])
@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 9, 30, 41])
@pytest.mark.parametrize("n", [1, 3, 1023, 70001, 524_288, 2_097_152,
                               4_200_000])
def test_dots_plan_covers_every_column(n, m, itemsize):
    for aligned in (True, False):
        width, items, rows, nblk, groups = fd.dots_plan(m, n, itemsize,
                                                        aligned)
        vec = fd.VEC_BYTES // itemsize
        assert width == (vec if aligned and n % vec == 0 else 1)
        nv = n // width
        per = build.BLOCK * items
        assert (nblk - 1) * per < nv <= nblk * per  # no idle CTA
        assert items in fd.ITEMS
        if nv <= fd.MAX_BLOCKS * build.BLOCK * max(fd.ITEMS):
            assert nblk <= fd.MAX_BLOCKS
            # the fewest items that do
            assert items == min(i for i in fd.ITEMS
                                if -(-nv // (build.BLOCK * i))
                                <= fd.MAX_BLOCKS)
        else:
            assert items == max(fd.ITEMS)
        assert rows == (4 if m <= 4 else 8)
        assert groups == -(-m // rows)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("m,n", [(1, 1), (3, 1023), (9, 70001),
                                 (5, 200_000)])
def test_dots_replay_matches_the_plain_version(m, n, dt):
    """The kernel's columns per CTA and thread (vector c = CTA * BLOCK *
    items + item * BLOCK + thread), its (groups, nblk, rows) partials and
    the finish's fixed order, against the plain version's sums."""
    rng = np.random.default_rng(m * n)
    V = rng.standard_normal((m, n)).astype(dt)
    z = rng.standard_normal(n).astype(dt)
    width, items, rows, nblk, groups = fd.dots_plan(m, n, V.itemsize)
    nv = n // width
    seen = np.zeros(nv, int)
    part = np.zeros((groups, nblk, rows), dt)
    for b in range(nblk):
        for it in range(items):
            c = b * build.BLOCK * items + it * build.BLOCK \
                + np.arange(build.BLOCK)
            c = c[c < nv]
            seen[c] += 1
            cols = (c[:, None] * width + np.arange(width)).ravel()
            for j in range(m):
                part[j // rows, b, j % rows] += np.sum(V[j, cols] * z[cols])
    assert (seen == 1).all()
    got = part.sum(axis=1).reshape(-1)[:m]
    want = fd.fused_dots_plain(torch.from_numpy(V),
                               torch.from_numpy(z)).numpy()
    tol = 1e-12 if dt == np.float64 else 1e-5
    assert np.all(np.abs(got - want) <= tol * np.abs(V * z).sum(-1) + 1e-30)
