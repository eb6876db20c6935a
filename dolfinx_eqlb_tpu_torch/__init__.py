"""dolfinx_eqlb_tpu_torch — the PyTorch/CUDA port of dolfinx_eqlb_tpu.

The JAX package ``dolfinx_eqlb_tpu`` is the reference; this package grows
beside it, module by module, with the same layout (``elements/``, ``mesh/``,
``native/``, ``fem/``, ``eqlb/``, ``elmtlib/``, ``models/``,
``estimation/``, ``ops/``, ``parallel/``, ``utils/``; the demos in
``demos/``, the entry points in ``entry``).
Host precompute (mesh topology, patch extraction, dof tables) is NumPy
copied from the reference; device stages are eager PyTorch, and every TPU
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``csrc/``, wrapped in ``ops/``) with a plain PyTorch version beside it.

Ported:

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
  ``demos.elasticity`` and ``demos.cook_adaptive``;
* geometric multigrid and Biot poro-elasticity: ``fem.multigrid``
  (``mesh_hierarchy``, ``GeometricMG``), the multigrid branches of the
  elasticity solvers, ``models.biot`` and ``demos.biot``;
* patch sharding over ``torch.distributed``:
  ``parallel.ShardedEqlbEngine`` (with ``EqlbEngine(pad_to_multiple=)``),
  ``parallel.spawn_ranks`` and the entry points ``entry.entry`` /
  ``entry.dryrun_multichip``;
* tooling: ``mesh.read_msh`` (Gmsh import), ``utils`` (``run_perftest``,
  ``sync`` / ``timed`` / ``trace``, ``write_vtu`` / ``write_xdmf`` /
  ``flux_cell_values``);
* the bench, ``bench`` (``bench.py``'s counterpart: ``python -m
  dolfinx_eqlb_tpu_torch.bench``, or ``bench_torch.py`` from the root).

Entry points run on the CUDA card by default and raise without one; pass
``device="cpu"`` for the CPU.  Nothing here imports jax.
"""

__version__ = "0.1.0"

from . import (  # noqa: F401
    elements, mesh, fem, eqlb, elmtlib, models, estimation, ops, parallel,
    utils,
)
