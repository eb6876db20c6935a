from .poisson import PoissonSolver, locate_dofs_on_facets  # noqa: F401
