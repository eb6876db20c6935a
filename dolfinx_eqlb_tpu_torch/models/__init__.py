from .poisson import PoissonSolver, locate_dofs_on_facets  # noqa: F401
from .elasticity import ElasticitySolver, stress_row_expr  # noqa: F401
