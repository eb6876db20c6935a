from .patch_solve import batched_kkt_solve_bl  # noqa: F401
from .lane_select import combine_gather  # noqa: F401
from .load_moments import fold_rhs, load_moments  # noqa: F401
from .reduced_step import reduced_step  # noqa: F401
from ._build import check_se_degree, launches, reset_launches  # noqa: F401
