from .poisson import PoissonSolver, locate_dofs_on_facets  # noqa: F401
from .elasticity import ElasticitySolver, stress_row_expr  # noqa: F401
from .biot import (  # noqa: F401
    BiotSolverUPP,
    BiotMG,
    biot_stress_row_expr,
    darcy_flux_expr,
    biot_flow_rhs_expr,
    biot_fields,
    biot_bench_fields,
)
