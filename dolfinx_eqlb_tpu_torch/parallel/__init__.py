"""Patch-parallel equilibration over ``torch.distributed``
(``ShardedEqlbEngine``) and the start of its ranks (``spawn_ranks``, ``rank_device``)."""
from .sharding import ShardedEqlbEngine  # noqa: F401
from .launch import rank_device, spawn_ranks  # noqa: F401
