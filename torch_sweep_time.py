#!/usr/bin/env python3
"""Time the sweep kernels of one checkout of the port.

    python3 torch_sweep_time.py [SRC]

``SRC`` is the ``src`` directory whose ``repro_torch`` is built and timed
(default: this checkout's), so one session on one card can time two
versions side by side: parent, change, change, parent.  Run on one NVIDIA
GPU (exits with 2 without one).  Times ``pipecg_spmv_fused`` at
chip_smoke.py's shapes (ex23's tridiagonal Laplacian at n = 2,097,152 and
``laplacian_2d(1448, 1448)``, the 21-band glen operator; k = 1 and 8;
float64, float32, float32 with bf16 storage) and ``pipecg_spmv_halo`` on
rank 1 of 4 (the tridiagonal Laplacian at k = 1 and 8 and with bf16
storage, the 2-D Laplacian) as CUDA-event medians of 25, after holding
each call's vectors bit for bit against its plain version.  Where the
checkout has the p-BiCGStab sweep, it times ``pipebicgstab_fused`` at
chip_smoke.py's shapes too (convection-diffusion and the 2-D Laplacian
in float64, float32, float32 with bf16 storage, glen in float64) and
``pipebicgstab_halo`` on rank 1 of 4 (float64 and bf16), and where it
has the depth-l ghost-chain sweep, ``ghost_chain_fused`` at chip_smoke.py's
shapes (ex23 at l = 2 and 4, the 2-D Laplacian at l = 2, the 21-band glen
operator at l = 4) and ``ghost_chain_halo`` on rank 1 of 4; where it has
the BSR sweep, ``pipecg_bsr_fused`` on ex23-bsr4 and lap2d-bsr4 (k = 1,
float64, vectors bit for bit against the plain version first); where it
has the flash kernel, ``flash_attention`` at the ``[serve]`` prefill's
(64, 2048, 128) bf16 causal (finite, and within 2^-8 of the float32 plain
version's rms first).  Prints the card's ``nvidia-smi`` name and power
limit, one line per shape, and one JSON object as its last line.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import chip_smoke as smoke


def main(argv) -> int:
    src = Path(argv[1]).resolve() if len(argv) > 1 else smoke.ROOT / "src"
    import torch
    if not torch.cuda.is_available():
        print("torch_sweep_time: no CUDA device", file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"torch_sweep_time: no repro_torch under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.krylov import (glen_law_band, laplacian_2d,
                                         tridiagonal_laplacian)
    from repro_torch.kernels import build
    from repro_torch.kernels.pipecg_spmv_fused import (
        pipecg_spmv_fused, pipecg_spmv_fused_plain, pipecg_spmv_halo,
        pipecg_spmv_halo_plain)

    _, line = smoke.card()
    print(line, flush=True)
    so, _ = build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    tri = tridiagonal_laplacian(smoke.N_EX23, device=dev)
    lap = laplacian_2d(1448, 1448, device=dev)
    out = []
    glen = glen_law_band(smoke.N_EX23, device=dev)
    for A, label, k, acc, sto, ranks in (
            (tri, "tridiag", 1, f64, f64, 1), (tri, "tridiag", 8, f64, f64, 1),
            (tri, "tridiag", 1, f32, f32, 1), (tri, "tridiag", 1, f32, bf16, 1),
            (lap, "lap2d", 1, f64, f64, 1), (lap, "lap2d", 8, f32, bf16, 1),
            (glen, "glen", 1, f64, f64, 1),
            (tri, "tridiag", 1, f64, f64, smoke.RANKS),
            (tri, "tridiag", 8, f64, f64, smoke.RANKS),
            (tri, "tridiag", 1, f32, bf16, smoke.RANKS),
            (lap, "lap2d", 1, f64, f64, smoke.RANKS)):
        def randn(dt):
            return torch.randn((k, A.n), generator=gen, device=dev,
                               dtype=f64).to(dt)
        x, r, u, p = randn(acc), randn(sto), randn(sto), randn(sto)
        a = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        b = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        if ranks == 1:
            fn, plain = pipecg_spmv_fused, pipecg_spmv_fused_plain
            args = (A.offsets, A.bands.to(sto), (1.0 / A.diagonal()).to(sto),
                    A.column_checksum().to(sto), x, r, u, p, a, b)
        else:
            fn, plain = pipecg_spmv_halo, pipecg_spmv_halo_plain
            opnds, _ = smoke.rank_operands(A, ranks, 1, x, r, u, p, sto)
            args = (A.offsets, *opnds, a, b)
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got[:4], want[:4]):
            smoke.check(torch.equal(g, w), f"{fn.__name__} {label} k={k} "
                        f"differs from the plain version")
        ms = smoke.time_ms(lambda: fn(*args))
        row = dict(kernel=fn.__name__, shape=label, ranks=ranks, k=k,
                   accum=str(acc)[6:], storage=str(sto)[6:], ms=ms)
        smoke.say("sweep", **row)
        out.append(row)
    kdir = src / "repro_torch" / "kernels"
    bicg, chain, bsr, flash = [], [], [], []
    if (kdir / "pipebicgstab_fused.py").exists():
        bicg = time_bicg(gen, lap)
    if (kdir / "csrc" / "ghost_chain.cu").exists():
        chain = time_chain(gen, tri, lap)
    if (kdir / "spmv_bsr.py").exists():
        bsr = time_bsr(gen, tri, lap)
    if (kdir / "flash_attn.py").exists():
        flash = time_flash(gen)
    print(json.dumps({"src": str(src), "library": so.name,
                      "sweep": out, "bicg": bicg, "chain": chain,
                      "bsr": bsr, "flash": flash}),
          flush=True)
    return 0


def time_bsr(gen, tri, lap):
    """CUDA-event medians of ``pipecg_bsr_fused`` (float64, k = 1) on
    ex23-bsr4 and lap2d-bsr4, each call's vectors held bit for bit against
    its plain version first."""
    import torch
    from repro_torch.core.krylov import dia_to_bsr
    from repro_torch.kernels.spmv_bsr import (pipecg_bsr_fused,
                                              pipecg_bsr_fused_plain)
    rows = []
    for A, label in ((tri, "ex23-bsr4"), (lap, "lap2d-bsr4")):
        B = dia_to_bsr(A, bs=smoke.BSR_BS)
        x, r, u, p = (torch.randn((1, B.n), generator=gen, device=gen.device,
                                  dtype=torch.float64) for _ in range(4))
        a, b = (torch.rand(1, generator=gen, device=gen.device,
                           dtype=torch.float64) for _ in range(2))
        args = (B.indices, B.blocks, (1.0 / B.diagonal()).contiguous(),
                B.column_checksum(), x, r, u, p, a, b)
        got, want = pipecg_bsr_fused(*args), pipecg_bsr_fused_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got[:4], want[:4]):
            smoke.check(torch.equal(g, w), f"pipecg_bsr_fused {label} differs")
        row = dict(kernel="pipecg_bsr_fused", shape=label, k=1,
                   accum="float64",
                   ms=smoke.time_ms(lambda: pipecg_bsr_fused(*args)))
        smoke.say("sweep", **row)
        rows.append(row)
    return rows


def time_flash(gen):
    """CUDA-event median of ``flash_attention`` at the [serve] prefill's
    shape, bf16 causal, after a finiteness and rms check against the
    float32 plain version (chip_smoke.py holds it to the full bar)."""
    import torch
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_plain)
    q, k, v = (torch.randn(smoke.FLASH_SHAPE, generator=gen,
                           device=gen.device).to(torch.bfloat16)
               for _ in range(3))
    got = flash_attention(q, k, v, True)
    want = flash_attention_plain(q.float(), k.float(), v.float(), True)
    gap = (got.float() - want).pow(2).mean().sqrt()
    smoke.check(bool(torch.isfinite(got).all())
                and float(gap) <= 2.0 ** -8 * float(want.pow(2).mean().sqrt()),
                f"flash_attention disagrees: rms gap {float(gap)}")
    row = dict(kernel="flash_attention",
               shape="x".join(map(str, smoke.FLASH_SHAPE)), dtype="bfloat16",
               causal=True, ms=smoke.time_ms(lambda: flash_attention(
                   q, k, v, True)))
    smoke.say("sweep", **row)
    return [row]


def time_chain(gen, tri, lap):
    """CUDA-event medians of the ghost-chain sweeps (float64), each chain
    held bit for bit against its plain version first."""
    import torch
    from repro_torch.core.krylov import dia_inf_norm, glen_law_band
    from repro_torch.kernels.pipecg_spmv_fused import (
        ghost_chain_fused, ghost_chain_fused_plain, ghost_chain_halo,
        ghost_chain_halo_plain)
    glen = glen_law_band(smoke.N_EX23, device=gen.device)
    rows = []
    for A, label, l, ranks in ((tri, "tridiag", 2, 1), (tri, "tridiag", 4, 1),
                               (lap, "lap2d", 2, 1), (glen, "glen", 4, 1),
                               (tri, "tridiag", 2, smoke.RANKS)):
        p, r = (torch.randn(A.n, generator=gen, device=gen.device,
                            dtype=torch.float64) for _ in range(2))
        theta = dia_inf_norm(A)
        if ranks == 1:
            fn, plain = ghost_chain_fused, ghost_chain_fused_plain
            args = (A.offsets, A.bands, p, r, theta, l)
        else:
            fn, plain = ghost_chain_halo, ghost_chain_halo_plain
            opnds, _ = smoke.chain_rank_operands(A, ranks, 1, p, r, l)
            args = (A.offsets, *opnds, theta, l)
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        smoke.chain_equal(f"{fn.__name__} {label}", got[0], want[0])
        row = dict(kernel=fn.__name__, shape=label, l=l, ranks=ranks,
                   ms=smoke.time_ms(lambda: fn(*args)))
        smoke.say("sweep", **row)
        rows.append(row)
    return rows


def time_bicg(gen, lap):
    """CUDA-event medians of the p-BiCGStab sweeps, each held bit for bit
    against its plain version first."""
    import torch
    from repro_torch.core.krylov import convection_diffusion, glen_law_band
    from repro_torch.kernels.pipebicgstab_fused import (
        pipebicgstab_fused, pipebicgstab_fused_plain, pipebicgstab_halo,
        pipebicgstab_halo_plain)
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    cdf = convection_diffusion(smoke.N_EX23, device=gen.device)
    rows = []
    glen = glen_law_band(smoke.N_EX23, device=gen.device)
    for A, label, acc, sto, ranks in ((cdf, "convdiff", f64, f64, 1),
                                      (lap, "lap2d", f64, f64, 1),
                                      (cdf, "convdiff", f32, f32, 1),
                                      (cdf, "convdiff", f32, bf16, 1),
                                      (glen, "glen", f64, f64, 1),
                                      (cdf, "convdiff", f64, f64,
                                       smoke.RANKS),
                                      (cdf, "convdiff", f32, bf16,
                                       smoke.RANKS)):
        bands, csum, x, chains, sc = smoke.bicg_operands(gen, A, acc, sto)
        if ranks == 1:
            fn, plain = pipebicgstab_fused, pipebicgstab_fused_plain
            args = (A.offsets, bands, csum, x, *chains, *sc)
        else:
            fn, plain = pipebicgstab_halo, pipebicgstab_halo_plain
            opnds, _ = smoke.bicg_rank_operands(A, ranks, 1, x, chains)
            args = (A.offsets, *opnds, *sc)
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        smoke.chains_equal(f"{fn.__name__} {label}", got, want)
        row = dict(kernel=fn.__name__, shape=label, ranks=ranks,
                   accum=str(acc)[6:], storage=str(sto)[6:],
                   ms=smoke.time_ms(lambda: fn(*args)))
        smoke.say("sweep", **row)
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(main(sys.argv))
