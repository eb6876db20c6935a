from .spaces import FunctionSpace, Function  # noqa: F401
from .expressions import (  # noqa: F401
    Expr,
    as_expr,
    as_vector,
    expr_from_callable,
    grad,
    div,
    comp,
    cell_scale,
)
from .projection import (  # noqa: F401
    local_projection,
    local_solver_cholesky,
    local_solver_lu,
    local_solver_cg,
)
from .interpolate import interpolate, project_facet_trace  # noqa: F401
from .assemble import cell_integrals, cell_integrals_sq, assemble_scalar  # noqa: F401
from .multigrid import GeometricMG, mesh_hierarchy  # noqa: F401
