from .patches import PatchBucket, build_patches, bucket_dof_tables  # noqa: F401
from .engine import EqlbEngine, reference_tensors  # noqa: F401
