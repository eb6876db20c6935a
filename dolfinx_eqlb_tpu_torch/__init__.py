"""dolfinx_eqlb_tpu_torch — the PyTorch/CUDA port of dolfinx_eqlb_tpu.

The JAX package ``dolfinx_eqlb_tpu`` is the reference; this package grows
beside it, module by module, with the same layout (``elements/``, ``mesh/``,
``native/``, ``fem/``, ``eqlb/``, ``elmtlib/``, ``models/``, ``ops/``).
Host precompute (mesh topology, patch extraction, dof tables) is NumPy
copied from the reference; device stages are eager PyTorch, and every TPU
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``csrc/``, wrapped in ``ops/``) with a plain PyTorch version beside it.

Ported so far:

* the batched equilibration engine, ``eqlb.engine.EqlbEngine.equilibrate``
  (semi-explicit, KKT and mixed-precision paths);
* the flux user API: ``fem`` (``Function``, expressions, ``interpolate``,
  ``local_projection``, assembly), ``eqlb`` (``fluxbc``, ``FluxEqlbSE``,
  ``FluxEqlbEV`` and the condition checks), ``elmtlib`` and
  ``models.PoissonSolver``, the primal solve that feeds them.

Entry points run on the CUDA card by default and raise without one; pass
``device="cpu"`` for the CPU.  Nothing here imports jax.
"""

__version__ = "0.1.0"

from . import elements, mesh, fem, eqlb, elmtlib, models, ops  # noqa: F401
