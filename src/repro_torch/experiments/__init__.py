"""Campaign experiments of the port: what is ported of the JAX package's
``experiments`` (the spec and its presets, the noise-name resolver, and
the serve stage).  The runner, fitting, validation, report and campaign
stages are not ported yet (ROADMAP.md queue 1).
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
from repro_torch.experiments.serve_exec import (  # noqa: F401
    bench_record,
    run_serve_exec,
)
