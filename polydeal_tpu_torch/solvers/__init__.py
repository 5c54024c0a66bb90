from polydeal_tpu_torch.solvers.amg import (
    AMG,
    block_nullspace,
    build_amg,
    constant_nullspace,
)
from polydeal_tpu_torch.solvers.cg import (
    CGResult,
    block_jacobi_preconditioner,
    cg_solve,
    jacobi_preconditioner,
)
from polydeal_tpu_torch.solvers.chebyshev import (
    ChebyshevSmoother,
    estimate_lambda_max,
)
from polydeal_tpu_torch.solvers.gmres import GMRESResult, gmres_solve
from polydeal_tpu_torch.solvers.multigrid import (
    Multigrid,
    Transfer,
    build_embedding,
    build_field_block_multigrid,
    build_multigrid,
    build_rtree_hierarchy,
    build_structured_hierarchy,
    detect_grid_shapes,
    galerkin_coarsen,
    relabel_band_minimizing,
)

__all__ = [
    "AMG",
    "build_amg",
    "block_nullspace",
    "constant_nullspace",
    "GMRESResult",
    "gmres_solve",
    "CGResult",
    "cg_solve",
    "block_jacobi_preconditioner",
    "jacobi_preconditioner",
    "ChebyshevSmoother",
    "estimate_lambda_max",
    "Multigrid",
    "Transfer",
    "build_embedding",
    "build_field_block_multigrid",
    "build_multigrid",
    "build_rtree_hierarchy",
    "build_structured_hierarchy",
    "detect_grid_shapes",
    "galerkin_coarsen",
    "relabel_band_minimizing",
]
