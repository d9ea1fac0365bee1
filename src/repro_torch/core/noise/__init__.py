"""OS-noise modelling: the Table-1 calibrated run generator, recorded-trace
distributions, host sampling, wall-clock noise injection into real solver
runs, fault injection (kill / stall / corrupt) for the elastic controller,
and the per-iteration phase model on the card's figures."""
from repro_torch.core.noise.faults import (  # noqa: F401
    FAULT_KINDS,
    FaultEvent,
    FaultInjector,
    FaultSpec,
    make_fault,
    make_faults,
)
from repro_torch.core.noise.injection import (  # noqa: F401
    NoiseHook,
    make_noise_hook,
)
from repro_torch.core.noise.sampling import (  # noqa: F401
    sample_np,
    scale_distribution,
)
from repro_torch.core.noise.simulator import (  # noqa: F401
    Hardware,
    SolverPhaseModel,
    apply_precision,
    ex23_models,
    predict_speedup,
)
from repro_torch.core.noise.traces import (  # noqa: F401
    EX23_ITERS,
    EX23_N,
    PIZ_DAINT_P,
    TABLE1,
    EmpiricalDistribution,
    RunModel,
    calibrated_model,
    generate_runs,
    makespan_trace_large,
    trace_distribution,
)
