"""Section 4 workflow on the PyTorch port: generate repeated runs, fit the
three candidate distributions, run Cramer-von Mises + Lilliefors, and
write the ECDF-with-fits CSVs (Figs. 5-6).

    PYTHONPATH=src python examples/stochastic_analysis_torch.py [--cpu]
                                                    [--out DIR]

The runs are drawn on the card (``--cpu``: on the CPU) through a seeded
``torch.Generator``; the CSVs go to ``chiprun_out/figures/`` unless
``--out`` names another directory.
"""
import argparse
from pathlib import Path

import torch

from repro_torch.core.noise import TABLE1, generate_runs
from repro_torch.core.stats import ecdf_with_fits, fit_report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="draw on the CPU instead of the card")
    ap.add_argument("--out", default="chiprun_out/figures",
                    help="directory of the ECDF CSVs")
    args = ap.parse_args()
    device = torch.device("cpu" if args.cpu else "cuda")
    name = "cpu" if args.cpu else torch.cuda.get_device_name(device)
    print(f"device={name}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"{'alg':8s} {'mean':>8s} {'median':>8s} {'s':>8s} {'lam':>8s} "
          f"{'min':>8s} {'max':>8s}")
    for alg in TABLE1:
        runs = generate_runs(alg, seed=4, device=device)
        rep = fit_report(runs, name=alg)
        s = rep.summary
        print(f"{alg:8s} {s['mean']:8.4f} {s['median']:8.4f} {s['s']:8.4f} "
              f"{s['lambda']:8.4f} {s['min']:8.4f} {s['max']:8.4f}")
        print(f"         paper: mean={TABLE1[alg]['mean']:.4f} "
              f"median={TABLE1[alg]['median']:.4f} s={TABLE1[alg]['s']:.4f}")
        print("         " + rep.verdict_row())
        x, F, fits = ecdf_with_fits(runs)
        csv = out / f"ecdf_{alg.lower()}.csv"
        with open(csv, "w") as f:
            f.write("x,ecdf," + ",".join(fits) + "\n")
            for i in range(len(x)):
                f.write(f"{float(x[i]):.6f},{float(F[i]):.6f},"
                        + ",".join(f"{float(fits[k][i]):.6f}" for k in fits)
                        + "\n")
        print(f"         ecdf+fits -> {csv}")


if __name__ == "__main__":
    main()
