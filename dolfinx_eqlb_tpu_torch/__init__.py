"""dolfinx_eqlb_tpu_torch — the PyTorch/CUDA port of dolfinx_eqlb_tpu.

The JAX package ``dolfinx_eqlb_tpu`` is the reference; this package grows
beside it, module by module, with the same layout (``elements/``, ``mesh/``,
``native/``, ``fem/``, ``eqlb/``, ``ops/``).  Host precompute (mesh
topology, patch extraction, dof tables) is NumPy copied from the reference;
device stages are eager PyTorch, and every TPU kernel on the ported path is
a hand-written CUDA kernel for Hopper (``csrc/``, wrapped in ``ops/``) with
a plain PyTorch version beside it.

Ported so far (slice 1): the fused semi-explicit RT_k flux equilibration,
``eqlb.engine.EqlbEngine.equilibrate``.  Nothing here imports jax.
"""

__version__ = "0.1.0"

from . import elements, mesh, fem, eqlb, ops  # noqa: F401
