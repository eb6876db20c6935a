from .patches import PatchBucket, build_patches, bucket_dof_tables  # noqa: F401
from .engine import EqlbEngine  # noqa: F401
from .semiexplicit import reference_tensors  # noqa: F401
from .bcs import fluxbc, FluxBC, boundarydata, BoundaryData  # noqa: F401
from .equilibrators import FluxEquilibrator, FluxEqlbEV, FluxEqlbSE  # noqa: F401
from . import checks  # noqa: F401
from .checks import (  # noqa: F401
    check_divergence_condition,
    check_jump_condition,
    check_jump_condition_per_facet,
    check_boundary_conditions,
    check_weak_symmetry_condition,
)
