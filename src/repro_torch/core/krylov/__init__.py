"""The paper's solvers: classical + pipelined CG/CR on one device."""
from repro_torch.core.krylov.abft import DetectionReport  # noqa: F401
from repro_torch.core.krylov.base import SolveResult, local_dot  # noqa: F401
from repro_torch.core.krylov.cg import (  # noqa: F401
    cg,
    cr,
    pipecg,
    pipecg_multi,
    pipecr,
)
from repro_torch.core.krylov.engine import (  # noqa: F401
    ENGINES,
    Engine,
    FusedEngine,
    NaiveEngine,
    ShardedFusedEngine,
    get_engine,
    register_engine,
)
from repro_torch.core.krylov.operator import (  # noqa: F401
    HaloSpec,
    SparseOperator,
    as_operator,
)
from repro_torch.core.krylov.operators import (  # noqa: F401
    DiaMatrix,
    MatFreeOperator,
    convection_diffusion,
    dia_gather_matvec,
    identity_preconditioner,
    jacobi_preconditioner,
    laplacian_2d,
    tridiagonal_laplacian,
)
from repro_torch.core.krylov.options import (  # noqa: F401
    UNSET,
    PrecisionPolicy,
    SolverOptions,
    as_policy,
    check_supported,
    resolve_options,
)
