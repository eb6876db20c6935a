"""The port's demos: the JAX package's ``demos/`` on the port.

Each runs as ``python -m dolfinx_eqlb_tpu_torch.demos.<name>`` and takes
``--device`` (the CUDA card by default, raising without one; ``--device
cpu`` for the plain versions on the CPU).  They write CSV, not XDMF.

* ``reconstruction``    — solve, project, equilibrate (SE or EV), check;
* ``error_estimation``  — the uniform series: estimator, H1 error, rates;
* ``lshape_adaptive``   — the adaptive L-shape loop (Doerfler marking,
  longest-edge bisection);
* ``discont_coeff``     — the adaptive Kellogg loop (discontinuous kappa);
* ``local_projection``  — cell-local L2 projection into DG2;
* ``elasticity``        — linear elasticity (u or u-p), weakly symmetric
  stress equilibration, Korn constants, the guaranteed bound;
* ``cook_adaptive``     — the adaptive Cook's-membrane loop;
* ``biot``              — Biot poro-elasticity (u-p-pt) by block-multigrid
  MINRES, its two stress rows and Darcy flux equilibrated in one call.
"""
