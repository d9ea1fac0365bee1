"""Quickstart on the PyTorch port: the paper in a minute.

1. Build the ex23 operator (tridiagonal 1-D Laplacian).
2. Solve with CG and PIPECG -> identical residual histories; GMRES and
   PGMRES -> the same solution.
3. Ask the stochastic model when pipelining beats 2x.

    PYTHONPATH=src python examples/quickstart_torch.py          # the card
    PYTHONPATH=src python examples/quickstart_torch.py --cpu    # no card

On the card the solvers run the fused engine (the CUDA kernels); with
``--cpu`` they run the same code on the kernels' plain versions.
"""
import argparse

import torch

from repro_torch.core.krylov import (SolverOptions, cg, gmres, pgmres,
                                     pipecg, tridiagonal_laplacian)
from repro_torch.core.perfmodel import (Exponential, LogNormal, Uniform,
                                        asymptotic_speedup, simulate)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--n", type=int, default=4096, help="problem size")
    args = ap.parse_args()
    device = torch.device("cpu" if args.cpu else "cuda")
    name = "cpu" if args.cpu else torch.cuda.get_device_name(device)
    print(f"device={name}")

    # --- 1/2: solver equivalence (paper Section 4) ----------------------
    n = args.n
    A = tridiagonal_laplacian(n, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    b = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    fused = SolverOptions(maxiter=300, engine="fused")

    r_cg = cg(A, b, options=fused)
    r_pipe = pipecg(A, b, options=fused)
    drift = float(torch.max(torch.abs(r_cg.res_history - r_pipe.res_history)
                            / (r_cg.res_history + 1e-30)))
    print(f"CG  final residual: {float(r_cg.res_norm):.6e}")
    print(f"PIPECG final residual: {float(r_pipe.res_norm):.6e}")
    print(f"max relative history drift: {drift:.2e}  (arithmetic "
          "equivalence)")

    g = gmres(A, b, restart=40, engine="fused")
    pg = pgmres(A, b, restart=40, engine="fused")
    print(f"GMRES vs PGMRES solution diff: "
          f"{float(torch.max(torch.abs(g.x - pg.x))):.2e}")

    # --- 3: the stochastic model (paper Section 3) ------------------------
    print("\nasymptotic pipelining speedup E[max_p T]/mu:")
    print(f"{'P':>6s} {'uniform':>9s} {'exponential':>12s} {'lognormal':>10s}")
    for P in (2, 4, 64, 8192):
        u = asymptotic_speedup(Uniform(0.0, 1.0), P)
        e = asymptotic_speedup(Exponential(1.0), P)
        ln = asymptotic_speedup(LogNormal(0.0, 1.0), P, method="quad",
                                device=device)
        print(f"{P:6d} {u:9.4f} {e:12.4f} {ln:10.4f}")
    print("uniform never exceeds 2x; exponential exceeds 2x from P=4 "
          "(25/12).")

    ms = simulate(Exponential(1.0), P=8, K=200, trials=200, device=device)
    print(f"\nsimulated makespans (P=8, K=200): T/T' = "
          f"{ms.speedup_of_means:.3f}")


if __name__ == "__main__":
    main()
