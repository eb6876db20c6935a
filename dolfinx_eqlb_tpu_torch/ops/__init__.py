from .patch_solve import batched_kkt_solve_bl  # noqa: F401
from .lane_select import combine_gather  # noqa: F401
