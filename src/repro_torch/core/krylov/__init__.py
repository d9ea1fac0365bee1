"""The paper's solvers: classical + pipelined CG/CR, GMRES/PGMRES,
BiCGStab and the depth-l pipelined CG/GMRES on DIA and BSR operators, on
one device or on the ranks of a process group, a chain or a 2-D grid
(``distributed_solve``)."""
from repro_torch.core.krylov.abft import DetectionReport  # noqa: F401
from repro_torch.core.krylov.base import (  # noqa: F401
    SolveResult,
    local_dot,
    make_allreduce_dot,
)
from repro_torch.core.krylov.bicgstab import (  # noqa: F401
    bicgstab,
    pbicgstab_scalars,
    pipebicgstab,
)
from repro_torch.core.krylov.cg import (  # noqa: F401
    cg,
    cr,
    pipecg,
    pipecg_multi,
    pipecr,
)
from repro_torch.core.krylov.distributed import (  # noqa: F401
    dia_matvec_local,
    distributed_solve,
    halo_exchange,
    halo_exchange_2d,
    halo_exchange_cols,
    sharded_pipebicgstab_solve,
    sharded_pipecg_bsr_solve,
    sharded_pipecg_depth_solve,
    sharded_pipecg_solve,
    sharded_pipecg_solve_2d,
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
from repro_torch.core.krylov.gmres import (  # noqa: F401
    gmres,
    gmres_restarted,
)
from repro_torch.core.krylov.hostops import (  # noqa: F401
    dia_matvec_np,
    true_residual_norm,
)
from repro_torch.core.krylov.operator import (  # noqa: F401
    BsrMatrix,
    HaloSpec,
    SparseOperator,
    as_operator,
    dia_to_bsr,
)
from repro_torch.core.krylov.operators import (  # noqa: F401
    DiaMatrix,
    MatFreeOperator,
    convection_diffusion,
    dia_gather_matvec,
    glen_law_band,
    identity_preconditioner,
    jacobi_preconditioner,
    laplacian_2d,
    tridiagonal_laplacian,
)
from repro_torch.core.krylov.pgmres import pgmres  # noqa: F401
from repro_torch.core.krylov.pipeline import (  # noqa: F401
    dia_inf_norm,
    pgmres_l,
    pipecg_l,
    symmetrized_jacobi,
)
from repro_torch.core.krylov.options import (  # noqa: F401
    UNSET,
    PrecisionPolicy,
    SolverOptions,
    as_policy,
    check_supported,
    resolve_options,
)
