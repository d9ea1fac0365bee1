"""Campaign experiments of the port (the JAX package's ``experiments``):
noise-injected Monte-Carlo solver runs with measured-vs-modeled speedup
validation.

The subsystem closes the loop between the model's layers:

* ``core/noise``      — discrete-event iteration model + wall-clock injection
* ``core/perfmodel``  — analytic E[max]/mu asymptotic speedups
* ``core/stats``      — MLE fits + Lilliefors / Cramer-von Mises tests

``python -m repro_torch.experiments.campaign --preset smoke`` sweeps
solver x engine x noise distribution x shard count, runs K repeated
trials per cell, fits the collected samples, validates measured speedup
ECDFs against the model, runs the execution stages on the card (or, with
``--device cpu``, on the plain versions) and writes ``figures/*.csv``,
``campaign.json`` and ``REPORT.md`` under its ``--out-dir`` (default
``chiprun_out/campaign``).
"""
from repro_torch.experiments.spec import (  # noqa: F401
    PRESETS,
    SOLVER_PAIRS,
    CampaignSpec,
    get_preset,
)
from repro_torch.experiments.noise_sources import (  # noqa: F401
    injected_family,
    make_distribution,
)
from repro_torch.experiments.runner import (  # noqa: F401
    measured_depth_makespans,
    measured_makespans,
    measured_s_sync_makespans,
    run_depth_exec,
    run_engine_exec,
)
from repro_torch.experiments.fitting import (  # noqa: F401
    classify_family,
    fit_cell,
)
from repro_torch.experiments.validation import (  # noqa: F401
    measured_crossover,
    modeled_speedup,
    validate_cells,
    validate_depth_cells,
    validate_s_sync_cells,
    validate_serve_cells,
)
from repro_torch.experiments.campaign import run_campaign  # noqa: F401
from repro_torch.experiments.serve_exec import (  # noqa: F401
    bench_record,
    run_serve_exec,
)
from repro_torch.experiments.report import (  # noqa: F401
    write_ecdf_csv,
    write_json,
    write_report_md,
    write_speedup_csv,
)
