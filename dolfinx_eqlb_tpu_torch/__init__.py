"""dolfinx_eqlb_tpu_torch — the PyTorch/CUDA port of dolfinx_eqlb_tpu.

The JAX package ``dolfinx_eqlb_tpu`` is the reference; this package grows
beside it, module by module, with the same layout (``elements/``, ``mesh/``,
``native/``, ``fem/``, ``eqlb/``, ``elmtlib/``, ``models/``,
``estimation/``, ``ops/``; the demos in ``demos/``).
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
  ``models.PoissonSolver``, the primal solve that feeds them;
* error estimation and adaptivity: ``estimation.estimate_poisson`` (SE,
  EV, a cell-wise coefficient), ``estimation.doerfler_mark``, ``mesh``'s
  ``lshape``, ``refine_uniform`` and ``refine_marked`` (longest-edge
  bisection), and the demos ``demos.reconstruction``,
  ``demos.error_estimation``, ``demos.lshape_adaptive``,
  ``demos.discont_coeff`` and ``demos.local_projection``, each run as
  ``python -m dolfinx_eqlb_tpu_torch.demos.<name>``;
* weakly symmetric stress equilibration: ``FluxEqlbSE(equilibrate_stress=
  True, estimate_korn_constant=True)`` (``eqlb.stress``, ``eqlb.grouping``,
  ``eqlb.korn``), ``models.elasticity`` (``ElasticitySolver``,
  ``ElasticitySolverUP`` on ``fem.krylov.minres``),
  ``estimation.estimate_elasticity``, ``mesh.cook_membrane`` and the demos
  ``demos.elasticity`` and ``demos.cook_adaptive``.

Not yet: multigrid and the Biot model, sharding, the I/O utilities.

Entry points run on the CUDA card by default and raise without one; pass
``device="cpu"`` for the CPU.  Nothing here imports jax.
"""

__version__ = "0.1.0"

from . import elements, mesh, fem, eqlb, elmtlib, models, estimation, ops  # noqa: F401
