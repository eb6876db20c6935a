from .poisson import estimate_poisson  # noqa: F401
from .elasticity import estimate_elasticity  # noqa: F401
from .marking import doerfler_mark  # noqa: F401
