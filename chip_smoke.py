#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, with nothing else: it builds the CUDA
kernels from src/repro_torch/kernels/csrc/ and then, one line per step,

1. device: the card's name and ``nvidia-smi`` name + power limit;
2. build: compiles the kernel library (one nvcc per source, in parallel);
3. kernels: each CUDA kernel against its plain torch version at the main
   path's shapes (ex23's n = 2,097,152 tridiagonal, float64; the 5-band
   ``laplacian_2d(1448, 1448)``; k = 1 and 8; float32; float32 with bf16
   storage; the per-rank halo sweep at the 4-rank local size 524,288 with
   real neighbour strips and operator rows, and 4 such slices summed
   against the one-device sweep; ``fused_dots`` at m = 3 and 30), with its
   CUDA-event time (median of 25), the plain version's, the library
   call's where one computes the same function (``torch.sparse`` CSR mv,
   ``torch.mv``), and its bound;
4. main path: ``pipecg(engine="fused", maxiter=5000)`` on ex23 with the
   launch counts read around it, its history held against
   ``engine="naive"``, then Jacobi, ``pipecg_multi`` (k=8) against 8 single
   solves, ``pipecr``, and a callable-M solve on the update-kernel fallback;
5. ranks: ex23 on 4 ranks of one process group, all on this card
   (``distributed_solve(pipecg, engine="sharded_fused", maxiter=5000)``,
   gloo with host-staged strips on one card, NCCL with one card per
   rank), its launch counts, split-phase order and history held against
   the one-device fused solve; 200-iteration pipecr, Jacobi,
   ``pipecg_multi`` (k=4), inline ``cg``/``pipecg`` and a 2-rank solve
   against theirs; the same solve under injected Exponential noise, whose
   history must equal the quiet one bit for bit;
6. model: ``asymptotic_speedup`` as in examples/quickstart.py and a
   ``simulate(Exponential(1), P=8192, K=200, trials=256)`` on the card;
7. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Every check raises: the script exits non-zero and prints no result when a
kernel does not build, does not launch or disagrees, when no CUDA device
is present, or when it is run outside a checkout.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# the device every phase runs on
DEVICE = "cuda"
# kernels of the one-device path (phase 4); the rank path's come in phase 5
ONE_DEVICE = ("spmv_dia", "pipecg_spmv_fused", "pipecg_fused")

# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity): memory 3.35 TB/s;
# float64 and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
N_EX23 = 2_097_152
MAXITER = 5000
CHECK_ITERS = 200
RANKS = 4
NOISE_SCALE = 1e-4   # seconds per unit draw: Exponential(1) waits, 100 us mean


class SmokeFailure(RuntimeError):
    """A phase found a fault."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes/HBM rate, flops/peak."""
    import torch
    key = "float64" if dtype == torch.float64 else "float32"
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[key] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls.

    Each sample first queues a spin kernel (``torch.cuda._sleep``) so the
    host has enqueued the call before the card reaches it: the events then
    bracket device time only, not Python's launch overhead.
    """
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def hist_close(ref, got, rtol=1e-10, floor_rel=1e-10) -> float:
    """Largest relative gap above the floor (the reference's _hist_close)."""
    ref, got = ref.double().cpu(), got.double().cpu()
    check(ref.shape == got.shape, f"history shapes {ref.shape} {got.shape}")
    mask = ref > floor_rel * max(float(ref.max()), 1.0)
    check(int(mask.sum()) > 0, "history entirely below the floor")
    gap = float(((got[mask] - ref[mask]).abs() / ref[mask]).max())
    check(gap <= rtol, f"histories differ by {gap:.3e} > {rtol}")
    return gap


def csr_of(A):
    """``torch.sparse`` CSR copy of a DIA operator (the library yardstick)."""
    import torch
    rows, cols, vals = [], [], []
    i = torch.arange(A.n, device=A.device)
    for k, off in enumerate(A.offsets):
        keep = (i + off >= 0) & (i + off < A.n)
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(A.bands[k][keep])
    with warnings.catch_warnings():  # torch.sparse's beta-state notices
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]),
            torch.cat(vals), (A.n, A.n))
        return coo.coalesce().to_sparse_csr()


def prepare() -> str:
    """Make the checkout's port importable; '' or why it cannot run here."""
    try:
        import torch
    except ImportError:
        return "torch is not installed"
    if not torch.cuda.is_available():
        return "no CUDA device; this script runs on the card"
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        return "run from the root of a checkout (src/repro_torch is missing)"
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ""


def card():
    """The card's name and nvidia-smi's 'name, power.limit' line."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return torch.cuda.get_device_name(0), smi.stdout.strip().splitlines()[0]


def ex23(gen):
    """The paper's problem on the card: tridiag(-1, 2, -1) at n = 2^21
    and a float64 right-hand side drawn from ``gen``."""
    import torch
    from repro_torch.core.krylov import tridiagonal_laplacian
    b = torch.randn(N_EX23, generator=gen, device=gen.device,
                    dtype=torch.float64)
    return tridiagonal_laplacian(N_EX23, device=gen.device), b


def phase_device():
    import torch
    name, line = card()
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(line, flush=True)
    return name, line


def phase_build():
    from repro_torch.kernels import build
    fresh = not build.library_path().exists()
    t0 = time.perf_counter()
    so, _ = build.build()
    build.lib()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", compiled=fresh,
        library=so.name)


def phase_kernels():
    """Each kernel against its plain version; returns the JSON records."""
    import torch
    from repro_torch.core.krylov import laplacian_2d, tridiagonal_laplacian
    from repro_torch.kernels.checksum import dia_column_checksum
    from repro_torch.kernels.pipecg_fused import (pipecg_fused,
                                                  pipecg_fused_plain)
    from repro_torch.kernels.pipecg_spmv_fused import (
        pipecg_spmv_fused, pipecg_spmv_fused_plain)
    from repro_torch.kernels.spmv_dia import spmv_dia, spmv_dia_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    tri = tridiagonal_laplacian(N_EX23, device=dev)
    lap = laplacian_2d(1448, 1448, device=dev)
    records = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=f64).to(dt)

    # -- #1 spmv_dia -------------------------------------------------------
    for A, label in ((tri, "tridiag"), (lap, "lap2d")):
        x = randn((A.n,), f64)
        y = spmv_dia(A.offsets, A.bands, x)
        want = spmv_dia_plain(A.offsets, A.bands, x)
        torch.cuda.synchronize()
        err = max_err([y], [want])
        scale = float(want.abs().max())
        check(err <= 1e-12 * scale, f"spmv_dia {label}: err {err}")
        ms = time_ms(lambda: spmv_dia(A.offsets, A.bands, x))
        plain_ms = time_ms(lambda: spmv_dia_plain(A.offsets, A.bands, x))
        b_ms, b_by = bound(nbytes(A.bands, x, y), 2.0 * len(A.offsets) * A.n,
                           x.dtype)
        lib_ms = None
        if label == "tridiag":
            csr = csr_of(A)
            lib_ms = time_ms(lambda: torch.mv(csr, x))
            check(max_err([torch.mv(csr, x)], [want]) <= 1e-12 * scale,
                  "CSR yardstick disagrees")
            records["spmv_dia"] = dict(
                name="spmv_dia", route="cuda",
                source="src/repro_torch/kernels/csrc/spmv_dia.cu",
                replaces="src/repro/kernels/spmv_dia.py:34",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        say("kernel", name="spmv_dia", shape=label, n=A.n, dtype="float64",
            max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
            library_ms=f"{lib_ms:.4f}" if lib_ms else None)

    # -- #2 pipecg_spmv_fused -------------------------------------------------
    cases = [(tri, "tridiag", 1, f64, f64), (tri, "tridiag", 8, f64, f64),
             (tri, "tridiag", 1, f32, f32), (tri, "tridiag", 1, f32, bf16),
             (lap, "lap2d", 1, f64, f64), (lap, "lap2d", 8, f32, bf16)]
    for A, label, k, acc, sto in cases:
        n = A.n
        x = randn((k, n), acc)
        r, u, p = (randn((k, n), sto) for _ in range(3))
        a = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        b = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        bands = A.bands.to(sto)
        invd = (1.0 / A.diagonal()).to(sto)
        csum = dia_column_checksum(A.offsets, bands)
        args = (A.offsets, bands, invd, csum, x, r, u, p, a, b)
        got = pipecg_spmv_fused(*args)
        want = pipecg_spmv_fused_plain(*args)
        torch.cuda.synchronize()
        vec_tol = {f64: 1e-12, f32: 1e-5}[acc]
        for i, (g, w) in enumerate(zip(got[:4], want[:4])):
            # bf16 stores: within one bf16 ulp (2^-7 relative)
            tol = 2.0 ** -7 if g.dtype == bf16 else vec_tol
            gap = float(((g.double() - w.double()).abs()
                         / w.double().abs().clamp(min=1.0)).max())
            check(gap <= tol, f"pipecg_spmv_fused {label} out{i}: {gap}")
        # partials: the sums run in another order than torch.sum, so each
        # is held relative to the sum of its terms' magnitudes
        u2, r2 = want[2].to(acc), want[1].to(acc)
        w2 = spmv_dia_plain(A.offsets, bands.to(acc), u2)
        mags = torch.stack(
            [t.abs().sum(-1) for t in (r2 * u2, w2 * u2, r2 * r2, r2 * w2,
                                       w2 * w2)]
            + [w2.abs().sum(-1) + (csum.to(acc) * u2).abs().sum(-1)], -1)
        rel = float(((got[4] - want[4]).abs() / mags).max())
        red_tol = 1e-3 if sto == bf16 else {f64: 1e-10, f32: 1e-5}[acc]
        check(rel <= red_tol, f"partials {label}: {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipecg_spmv_fused(*args))
        plain_ms = time_ms(lambda: pipecg_spmv_fused_plain(*args))
        flops = k * n * (4 * len(A.offsets) + 22)
        b_ms, b_by = bound(nbytes(bands, invd, csum, x, r, u, p, a, b,
                                  *got), flops, acc)
        say("kernel", name="pipecg_spmv_fused", shape=label, k=k,
            accum=str(acc)[6:], storage=str(sto)[6:],
            max_abs_err=f"{err:.3e}", partial_rel=f"{rel:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.4f}")
        if (label, k, acc, sto) == ("tridiag", 1, f64, f64):
            records["pipecg_spmv_fused"] = dict(
                name="pipecg_spmv_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/pipecg_spmv_fused.cu",
                replaces="src/repro/kernels/pipecg_spmv_fused.py:223",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # -- #6 pipecg_fused -----------------------------------------------------
    for k, acc in ((1, f64), (8, f64), (1, f32)):
        vecs = [randn((k, N_EX23), acc) for _ in range(10)]
        a = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        b = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        got = pipecg_fused(*vecs, a, b)
        want = pipecg_fused_plain(*vecs, a, b)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got[:8], want[:8])):
            check(torch.equal(g, w), f"pipecg_fused out{i} differs")
        r2, u2, w2 = want[1], want[2], want[3]
        mags = torch.stack([t.abs().sum(-1) for t in (r2 * u2, w2 * u2,
                                                       r2 * r2)], -1)
        rel = float(((got[8] - want[8]).abs() / mags).max())
        check(rel <= {f64: 1e-10, f32: 1e-5}[acc], f"pipecg_fused dots {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipecg_fused(*vecs, a, b))
        plain_ms = time_ms(lambda: pipecg_fused_plain(*vecs, a, b))
        b_ms, b_by = bound(nbytes(*vecs, a, b, *got), 22.0 * k * N_EX23, acc)
        say("kernel", name="pipecg_fused", n=N_EX23, k=k, accum=str(acc)[6:],
            max_abs_err=f"{err:.3e}", dots_rel=f"{rel:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}")
        if (k, acc) == (1, f64):
            records["pipecg_fused"] = dict(
                name="pipecg_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/pipecg_fused.cu",
                replaces="src/repro/kernels/pipecg_fused.py:63",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)

    halo_kernel(records, gen, tri, lap)
    halo_slices_sum_to_sweep(gen, tri)
    dots_kernel(records, gen)
    return records


def rank_operands(A, P, q, x, r, u, p, sto):
    """Rank q of P's sweep operands cut from global (k, n) vectors: the
    operator rows [lo - h, hi + h) and the u/p strips [lo - 2h, lo) and
    [hi, hi + 2h), zero beyond the matrix, as the halo exchange gives them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.checksum import dia_column_checksum
    h, n = A.halo, A.n
    lo, hi = q * n // P, (q + 1) * n // P
    bands = F.pad(A.bands, (h, h))[:, lo:hi + 2 * h]
    invd = F.pad(1.0 / A.diagonal(), (h, h))[lo:hi + 2 * h]
    csum = dia_column_checksum(A.offsets, bands, halo=h)
    wide = [F.pad(v, (2 * h, 2 * h)) for v in (u, p)]
    strips = []
    for v in wide:
        strips += [v[:, lo:lo + 2 * h], v[:, hi + 2 * h:hi + 4 * h]]
    cut = [v[:, lo:hi] for v in (x, r, u, p)]
    ops_ = [bands.to(sto), invd.to(sto), csum.to(sto), cut[0],
            *(v.to(sto) for v in cut[1:]), *(s.to(sto) for s in strips)]
    return [t.contiguous() for t in ops_], slice(lo, hi)


def halo_kernel(records, gen, tri, lap):
    """#3: the per-rank sweep on an interior rank (real strips, real
    neighbour operator rows) against its plain version."""
    import torch
    from repro_torch.kernels.pipecg_spmv_fused import (
        pipecg_spmv_halo, pipecg_spmv_halo_plain)
    from repro_torch.kernels.spmv_dia import spmv_dia_plain
    dev = tri.device
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    cases = [(tri, "tridiag", RANKS, 1, f64, f64),
             (tri, "tridiag", RANKS, 8, f64, f64),
             (tri, "tridiag", 1, 1, f64, f64),
             (tri, "tridiag", 1, 8, f64, f64),
             (tri, "tridiag", RANKS, 1, f32, bf16),
             (lap, "lap2d", RANKS, 1, f64, f64)]
    for A, label, P, k, acc, sto in cases:
        x, r, u, p = (torch.randn((k, A.n), generator=gen, device=dev,
                                  dtype=f64).to(acc) for _ in range(4))
        a = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        b = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        q = min(1, P - 1)
        opnds, _ = rank_operands(A, P, q, x, r, u, p, sto)
        args = (A.offsets, *opnds, a, b)
        got = pipecg_spmv_halo(*args)
        want = pipecg_spmv_halo_plain(*args)
        torch.cuda.synchronize()
        vec_tol = {f64: 1e-12, f32: 1e-5}[acc]
        for i, (g, w) in enumerate(zip(got[:4], want[:4])):
            tol = 2.0 ** -7 if g.dtype == bf16 else vec_tol
            gap = float(((g.double() - w.double()).abs()
                         / w.double().abs().clamp(min=1.0)).max())
            check(gap <= tol, f"pipecg_spmv_halo {label} out{i}: {gap}")
        # the partials against the sum of their terms' magnitudes, the
        # terms taken over the rank's rows from the plain version's vectors
        h = A.halo
        r2, u2 = want[1].to(acc), want[2].to(acc)
        u_ext = torch.cat([torch.zeros((k, h), dtype=acc, device=dev), u2,
                           torch.zeros((k, h), dtype=acc, device=dev)], -1)
        w2 = spmv_dia_plain(A.offsets, opnds[0].to(acc), u_ext)[:, h:-h]
        c = opnds[2].to(acc)
        mags = torch.stack(
            [t.abs().sum(-1) for t in (r2 * u2, w2 * u2, r2 * r2, r2 * w2,
                                       w2 * w2)]
            + [w2.abs().sum(-1) + (c * u2).abs().sum(-1)], -1)
        rel = float(((got[4] - want[4]).abs() / mags).max())
        red_tol = 1e-3 if sto == bf16 else {f64: 1e-10, f32: 1e-5}[acc]
        check(rel <= red_tol, f"halo partials {label}: {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipecg_spmv_halo(*args))
        plain_ms = time_ms(lambda: pipecg_spmv_halo_plain(*args))
        n = x.shape[-1] // P
        flops = k * n * (4 * len(A.offsets) + 22)
        b_ms, b_by = bound(nbytes(*opnds, a, b, *got), flops, acc)
        say("kernel", name="pipecg_spmv_halo", shape=label, ranks=P,
            n_local=n, h=h, k=k, accum=str(acc)[6:], storage=str(sto)[6:],
            max_abs_err=f"{err:.3e}", partial_rel=f"{rel:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.4f}")
        if (label, P, k, acc) == ("tridiag", RANKS, 1, f64):
            records["pipecg_spmv_halo"] = dict(
                name="pipecg_spmv_halo", route="cuda",
                source="src/repro_torch/kernels/csrc/pipecg_spmv_fused.cu",
                replaces="src/repro/kernels/pipecg_spmv_fused.py:252",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def halo_slices_sum_to_sweep(gen, A):
    """4 ranks' sweeps on slices of one global state: their vectors equal
    the one-device sweep's rows bit for bit, their partials sum to its row."""
    import torch
    from repro_torch.kernels.pipecg_spmv_fused import (pipecg_spmv_fused,
                                                       pipecg_spmv_halo)
    dev, f64 = A.device, torch.float64
    x, r, u, p = (torch.randn((1, A.n), generator=gen, device=dev,
                              dtype=f64) for _ in range(4))
    a = torch.rand(1, generator=gen, device=dev, dtype=f64)
    b = torch.rand(1, generator=gen, device=dev, dtype=f64)
    invd = (1.0 / A.diagonal()).contiguous()
    whole = pipecg_spmv_fused(A.offsets, A.bands, invd, A.column_checksum(),
                              x, r, u, p, a, b)
    total = torch.zeros_like(whole[4])
    for q in range(RANKS):
        opnds, rows = rank_operands(A, RANKS, q, x, r, u, p, f64)
        got = pipecg_spmv_halo(A.offsets, *opnds, a, b)
        for i, (g, w) in enumerate(zip(got[:4], whole[:4])):
            check(torch.equal(g, w[:, rows]), f"rank {q} out{i} differs")
        total = total + got[4]
    torch.cuda.synchronize()
    rel = float(((total - whole[4]).abs()
                 / whole[4].abs().clamp(min=1.0)).max())
    check(rel <= 1e-10, f"rank partials sum off by {rel}")
    say("kernel", check="4 rank slices == one-device sweep", n=A.n,
        vectors="bit-equal", partials_rel=f"{rel:.3e}")


def dots_kernel(records, gen):
    """#7: fused_dots against its plain version and torch.mv."""
    import torch
    from repro_torch.kernels.fused_dots import fused_dots, fused_dots_plain
    dev, f64 = gen.device, torch.float64
    for m, n in ((3, N_EX23 // RANKS), (30, N_EX23)):
        V = torch.randn((m, n), generator=gen, device=dev, dtype=f64)
        z = torch.randn(n, generator=gen, device=dev, dtype=f64)
        got = fused_dots(V, z)
        want = fused_dots_plain(V, z)
        lib = torch.mv(V, z)
        torch.cuda.synchronize()
        mags = (V * z).abs().sum(-1)
        rel = float(((got - want).abs() / mags).max())
        check(rel <= 1e-12, f"fused_dots m={m}: {rel}")
        check(float(((lib - want).abs() / mags).max()) <= 1e-12,
              "torch.mv yardstick disagrees")
        err = max_err([got], [want])
        ms = time_ms(lambda: fused_dots(V, z))
        plain_ms = time_ms(lambda: fused_dots_plain(V, z))
        lib_ms = time_ms(lambda: torch.mv(V, z))
        b_ms, b_by = bound(nbytes(V, z, got), 2.0 * m * n, f64)
        say("kernel", name="fused_dots", m=m, n=n, dtype="float64",
            max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
            bound_ms=f"{b_ms:.4f}")
        if m == 3:
            records["fused_dots"] = dict(
                name="fused_dots", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_dots.cu",
                replaces="src/repro/kernels/fused_dots.py:32",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def phase_main_path(records):
    """The ex23 solve and its siblings, with the launch counts around them.

    The counts are set to 0 before the path's solves and read right after
    them; the fused solves that only serve as comparisons run later.
    """
    import torch
    from repro_torch.core.krylov import (SolverOptions, pipecg, pipecg_multi,
                                         pipecr)
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    A, b = ex23(gen)
    B = torch.randn(8, N_EX23, generator=gen, device=dev, dtype=torch.float64)
    half = lambda z: 0.5 * z  # noqa: E731  an opaque callable M
    cb_iters = 100

    def fused(**kw):
        return SolverOptions(engine="fused", **kw)

    def counted(fn):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = ops.launch_counts()
        return out, dt, {k: after[k] - before[k] for k in after}

    ops.reset_launch_counts()
    # the paper's experiment: 5000 forced iterates on the fused engine
    res, dt, d_main = counted(lambda: pipecg(A, b, options=fused(
        maxiter=MAXITER)))
    jac, _, d_jac = counted(lambda: pipecg(A, b, options=fused(
        maxiter=CHECK_ITERS, M="jacobi")))
    multi, dt_multi, d_multi = counted(lambda: pipecg_multi(
        A, B, maxiter=CHECK_ITERS, engine="fused"))
    pcr, _, _ = counted(lambda: pipecr(A, b, options=fused(
        maxiter=CHECK_ITERS)))
    cb, dt_cb, d_cb = counted(lambda: pipecg(A, b, options=fused(
        maxiter=cb_iters, M=half)))
    counts = ops.launch_counts()
    say("main", launches=json.dumps(counts, separators=(",", ":")))
    for name in ONE_DEVICE:
        records[name]["launches"] = counts[name]
        check(counts[name] > 0, f"{name} never launched on the main path")

    check(d_main["pipecg_spmv_fused"] == MAXITER,
          f"pipecg_spmv_fused ran {d_main['pipecg_spmv_fused']} times")
    check(d_main["spmv_dia"] == 2, f"init SpMVs: {d_main['spmv_dia']}")
    check(d_main["pipecg_fused"] == 0, "the sweep path took the fallback")
    hist = res.res_history
    check(tuple(hist.shape) == (MAXITER,), f"history {tuple(hist.shape)}")
    check(bool(torch.isfinite(hist).all())
          and bool(torch.isfinite(res.x).all()), "non-finite solve")
    check(int(res.iters) == MAXITER, f"iters {int(res.iters)}")
    say("main", solve="pipecg fused", n=N_EX23, maxiter=MAXITER,
        seconds=f"{dt:.3f}", ms_per_iter=f"{dt / MAXITER * 1e3:.4f}",
        kernel_ms=f"{records['pipecg_spmv_fused']['ms']:.4f}",
        res0=f"{float(hist[0]):.6e}", res_last=f"{float(hist[-1]):.6e}",
        launches=json.dumps(d_main, separators=(",", ":")))
    naive, dt_naive, _ = counted(lambda: pipecg(A, b, options=SolverOptions(
        engine="naive", maxiter=CHECK_ITERS)))
    gap = hist_close(naive.res_history, hist[:CHECK_ITERS])
    say("main", check="fused vs naive history", iters=CHECK_ITERS,
        max_rel_gap=f"{gap:.3e}",
        naive_ms_per_iter=f"{dt_naive / CHECK_ITERS * 1e3:.4f}")

    check(d_jac["pipecg_spmv_fused"] == CHECK_ITERS, "jacobi sweep count")
    jn = pipecg(A, b, options=SolverOptions(engine="naive",
                                            maxiter=CHECK_ITERS, M="jacobi"))
    gap = hist_close(jn.res_history, jac.res_history)
    say("main", check="jacobi fused vs naive", max_rel_gap=f"{gap:.3e}")

    check(d_multi["pipecg_spmv_fused"] == CHECK_ITERS,
          "pipecg_multi: one sweep per iteration for all 8 systems")
    check(tuple(multi.res_history.shape) == (8, CHECK_ITERS), "multi shape")
    gaps = []
    for j in range(8):
        one = pipecg(A, B[j], options=fused(maxiter=CHECK_ITERS))
        gaps.append(hist_close(one.res_history, multi.res_history[j],
                               rtol=1e-12))
    say("main", check="pipecg_multi k=8 vs 8 single solves",
        max_rel_gap=f"{max(gaps):.3e}",
        ms_per_iter=f"{dt_multi / CHECK_ITERS * 1e3:.4f}")

    pcrn = pipecr(A, b, options=SolverOptions(engine="naive",
                                              maxiter=CHECK_ITERS))
    gap = hist_close(pcrn.res_history, pcr.res_history)
    say("main", check="pipecr fused vs naive", max_rel_gap=f"{gap:.3e}")

    check(d_cb["pipecg_fused"] == cb_iters, f"pipecg_fused ran {d_cb}")
    check(d_cb["spmv_dia"] == cb_iters + 3, f"fallback SpMVs {d_cb}")
    check(d_cb["pipecg_spmv_fused"] == 0, "a callable M reached the sweep")
    cbn = pipecg(A, b, options=SolverOptions(engine="naive",
                                             maxiter=cb_iters, M=half))
    gap = hist_close(cbn.res_history, cb.res_history)
    say("main", check="callable-M fallback vs naive",
        max_rel_gap=f"{gap:.3e}",
        ms_per_iter=f"{dt_cb / cb_iters * 1e3:.4f}")


def wall(per_rank, i: int) -> float:
    """Wall seconds of case i: the slowest rank's."""
    return max(outcomes[i]["seconds"] for outcomes in per_rank)


def phase_ranks(records):
    """ex23 on RANKS ranks of one group on this card, against one device.

    Every rank runs ``ranks.solve_cases`` (the launch counts are reset
    just before each solve and read just after it, in the rank); the
    one-device counterparts run here afterwards.
    """
    import torch
    from repro_torch.core.krylov import (SolverOptions, cg, pipecg,
                                         pipecg_multi, pipecr,
                                         tridiagonal_laplacian)
    from repro_torch.core.perfmodel import Exponential, asymptotic_speedup
    from repro_torch.distributed import ranks

    cpu = torch.Generator().manual_seed(2)
    A = tridiagonal_laplacian(N_EX23, device="cpu")
    b = torch.randn(N_EX23, generator=cpu, dtype=torch.float64)
    B = torch.randn((4, N_EX23), generator=cpu, dtype=torch.float64)
    sharded = dict(engine="sharded_fused")
    it = CHECK_ITERS
    cases = {
        "main": ("pipecg", b, dict(sharded, maxiter=MAXITER), None),
        "quiet": ("pipecg", b, dict(sharded, maxiter=it), None),
        "noisy": ("pipecg", b, dict(sharded, maxiter=it),
                  (Exponential(1.0), NOISE_SCALE, 0)),
        "pipecr": ("pipecr", b, dict(sharded, maxiter=it), None),
        "jacobi": ("pipecg", b, dict(sharded, maxiter=it, M="jacobi"), None),
        "multi": ("pipecg_multi", B, dict(sharded, maxiter=it), None),
        "cg inline": ("cg", b, dict(maxiter=it), None),
        "pipecg inline": ("pipecg", b, dict(maxiter=it), None),
    }
    names = list(cases)
    spec = [dict(solver=sv, A=A, b=rhs, kw=kw, noise=nz)
            for sv, rhs, kw, nz in cases.values()]
    backend = ranks.backend_for(RANKS, DEVICE)
    t0 = time.perf_counter()
    out = ranks.run(ranks.solve_cases, RANKS, spec, DEVICE, device=DEVICE)
    say("ranks", ranks=RANKS, backend=backend, cards=torch.cuda.device_count(),
        spawn_and_solves_s=f"{time.perf_counter() - t0:.1f}")
    # the 200-iteration solve on fewer ranks: what one rank alone costs
    few = {P: ranks.run(ranks.solve_cases, P, spec[1:2], DEVICE,
                        device=DEVICE) for P in (1, 2)}

    # the main path's launches: the 5000-iterate solve, summed over ranks
    for name in ("pipecg_spmv_halo", "fused_dots"):
        records[name]["launches"] = sum(o[0]["launches"][name] for o in out)
        check(records[name]["launches"] > 0,
              f"{name} never launched on the rank path")
    for i, name in enumerate(names):
        summed = {k: sum(o[i]["launches"][k] for o in out)
                  for k in out[0][i]["launches"]}
        say("ranks", case=repr(name), launches_summed_over_ranks=json.dumps(
            summed, separators=(",", ":")))
    for rank, outcomes in enumerate(out):
        for name, o in zip(names, outcomes):
            if cases[name][2].get("engine"):
                check(o["order_ok"] is True,
                      f"rank {rank} {name}: split-phase order broken")
            check(o["launches"]["pipecg_spmv_fused"] == 0,
                  f"rank {rank} {name}: the one-device sweep ran")
            ref = out[0][names.index(name)]
            check(all(np.array_equal(o[k], ref[k]) for k in
                      ("x", "res_history", "iters")),
                  f"rank {rank} {name}: ranks disagree")
        main = outcomes[0]
        check(main["launches"]["pipecg_spmv_halo"] == MAXITER,
              f"rank {rank}: {main['launches']['pipecg_spmv_halo']} sweeps")
        check(main["launches"]["fused_dots"] == 3,
              f"rank {rank}: init multi-dots {main['launches']}")
    res = {name: out[0][i] for i, name in enumerate(names)}
    say("ranks", solve="pipecg sharded_fused", n=N_EX23, ranks=RANKS,
        maxiter=MAXITER, seconds=f"{wall(out, 0):.3f}",
        ms_per_iter=f"{wall(out, 0) / MAXITER * 1e3:.4f}",
        launches=json.dumps(out[0][0]["launches"], separators=(",", ":")),
        order="issue(i)<halo(i+1)<wait(i)<launch(i+1) on every rank")
    # host time per iteration between the recorded events, mean of ranks
    seg = {k: np.mean([o[0]["segments"][k] for o in out]) * 1e6
           for k in out[0][0]["segments"]}
    say("ranks", host_us_per_iter=" ".join(f"{k}={v:.1f}"
                                           for k, v in seg.items()))

    dev = torch.device(DEVICE)
    Ad, bd, Bd = (tridiagonal_laplacian(N_EX23, device=dev), b.to(dev),
                  B.to(dev))
    fused = lambda **kw: SolverOptions(engine="fused", **kw)  # noqa: E731
    one = pipecg(Ad, bd, options=fused(maxiter=MAXITER))
    h_main = torch.from_numpy(res["main"]["res_history"])
    gap = hist_close(one.res_history[:it], h_main[:it])
    full_gap = float(((h_main - one.res_history.cpu()).abs()
                      / one.res_history.cpu()).max())
    xs = torch.from_numpy(res["main"]["x"])
    x_gap = float((xs - one.x.cpu()).abs().max() / one.x.cpu().abs().max())
    check(x_gap <= 1e-8, f"gathered x off by {x_gap}")
    say("ranks", check="4 ranks vs one-device fused", iters=it,
        max_rel_gap=f"{gap:.3e}", all_iters_max_rel_gap=f"{full_gap:.3e}",
        x_rel_gap=f"{x_gap:.3e}")
    singles = {
        "pipecr": pipecr(Ad, bd, options=fused(maxiter=it)).res_history,
        "jacobi": pipecg(Ad, bd, options=fused(maxiter=it, M="jacobi")
                         ).res_history,
        "multi": pipecg_multi(Ad, Bd, maxiter=it, engine="fused"
                              ).res_history,
        "cg inline": cg(Ad, bd, options=SolverOptions(maxiter=it)
                        ).res_history,
        "pipecg inline": pipecg(Ad, bd, options=SolverOptions(maxiter=it)
                                ).res_history,
    }
    for name, want in singles.items():
        gap = hist_close(want, torch.from_numpy(res[name]["res_history"]))
        say("ranks", check=f"{name} 4 ranks vs one device", iters=it,
            max_rel_gap=f"{gap:.3e}",
            ms_per_iter=f"{wall(out, names.index(name)) / it * 1e3:.4f}")
    for P, per_rank in few.items():
        gap = hist_close(one.res_history[:it],
                         torch.from_numpy(per_rank[0][0]["res_history"]))
        seg = " ".join(f"{k}={v * 1e6:.1f}"
                       for k, v in per_rank[0][0]["segments"].items())
        say("ranks", check=f"{P} rank(s) vs one device", iters=it,
            max_rel_gap=f"{gap:.3e}",
            ms_per_iter=f"{wall(per_rank, 0) / it * 1e3:.4f}",
            host_us_per_iter_rank0=seg)

    qi, ni = names.index("quiet"), names.index("noisy")
    for rank, outcomes in enumerate(out):
        q, nz = outcomes[qi], outcomes[ni]
        check(np.array_equal(q["res_history"], nz["res_history"])
              and np.array_equal(q["x"], nz["x"]),
              f"rank {rank}: noise changed the solve")
        draws = np.random.default_rng((0, rank)).exponential(
            1.0, size=it) * NOISE_SCALE
        check(np.array_equal(nz["waits"], draws),
              f"rank {rank}: waits are not the (0, {rank}) substream")
    quiet_s, noisy_s = wall(out, qi), wall(out, ni)
    mean_wait = np.mean([o[ni]["waits"].mean() for o in out])
    speedup = asymptotic_speedup(Exponential(1.0), RANKS)
    say("ranks", noise=f"Exponential(1) x {NOISE_SCALE} s", iters=it,
        history="bit-equal to quiet", quiet_s=f"{quiet_s:.4f}",
        noisy_s=f"{noisy_s:.4f}",
        added_us_per_iter=f"{(noisy_s - quiet_s) / it * 1e6:.1f}",
        mean_wait_per_rank_us=f"{mean_wait * 1e6:.1f}",
        asymptotic_speedup_P4=f"{speedup:.4f}")


def phase_model():
    import torch
    from repro_torch.core.perfmodel import (Exponential, LogNormal, Uniform,
                                            asymptotic_speedup, harmonic,
                                            simulate)
    for P in (2, 4, 64, 8192):
        u = asymptotic_speedup(Uniform(0.0, 1.0), P)
        e = asymptotic_speedup(Exponential(1.0), P)
        ln = asymptotic_speedup(LogNormal(0.0, 1.0), P, method="quad")
        check(all(v == v and v > 0 for v in (u, e, ln)), "speedups")
        say("model", P=P, uniform=f"{u:.4f}", exponential=f"{e:.4f}",
            lognormal=f"{ln:.4f}")
    check(abs(asymptotic_speedup(Exponential(1.0), 4) - 25 / 12) < 1e-14,
          "H_4")
    K, P = 200, 8192
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = simulate(Exponential(1.0), P=P, K=K, trials=256, batch=32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(ms.t_sync.device.type == "cuda", "simulate left the card")
    step = float(ms.t_sync.mean()) / K
    check(abs(step / harmonic(P) - 1.0) < 0.01,
          f"E[max] per step {step} vs H_P {harmonic(P)}")
    sp = ms.speedup_of_means
    check(sp > 2.0, f"speedup_of_means {sp}")
    say("model", simulate=f"Exponential(1) P={P} K={K} trials=256",
        draws=256 * K * P, seconds=f"{dt:.3f}",
        t_sync_per_step=f"{step:.4f}", H_P=f"{harmonic(P):.4f}",
        speedup_of_means=f"{sp:.4f}")


def main() -> int:
    why = prepare()
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 2
    import torch

    name, _ = phase_device()
    phase_build()
    records = phase_kernels()
    phase_main_path(records)
    phase_ranks(records)
    phase_model()
    order = ("spmv_dia", "pipecg_spmv_fused", "pipecg_spmv_halo",
             "pipecg_fused", "fused_dots")
    print(json.dumps({"kernels": [records[k] for k in order]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
