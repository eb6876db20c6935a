"""Demo: 3-field poro-elasticity (Biot u-p-pt) equilibration.

Port of the JAX package's ``demos/demo_biot.py`` (reference
``python/test/performance/perftest_basics.py:294-382``, testcase
``Biot_upp``): one coupled primal solve, by block-multigrid MINRES on a
red-refinement hierarchy (``models.biot.BiotMG``), gives three fields
that one ``FluxEqlbSE(..., equilibrate_stress=True)`` call equilibrates
together: two weakly symmetric (negated total) stress rows and the Darcy
flux.  Prints the divergence residual and the H(div) jump check of each
field and the weak-symmetry check of the stress rows, writes them as CSV,
and writes the two pressures at the vertices as ``biot_pressure.xdmf``
(the reference demo's output).

Run:  python -m dolfinx_eqlb_tpu_torch.demos.biot [--n 16] [--order 2]
      [--outfile F.csv] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from ..eqlb import (
    FluxEqlbSE,
    check_jump_condition,
    check_weak_symmetry_condition,
)
from ..eqlb.checks import DIVERGENCE_ATOL, divergence_error
from ..fem import FunctionSpace, expr_from_callable, local_projection
from ..fem.multigrid import mesh_hierarchy
from ..fem.spaces import resolve_device
from ..mesh import unit_square
from ..models.biot import BiotSolverUPP, biot_fields
from ..utils.io import write_xdmf
from ._stages import Stages

__all__ = ["f_body", "g_flow", "run", "CSV_HEADER"]

FIELDS = ["stress row 0", "stress row 1", "Darcy flux"]
CSV_HEADER = ["field", "divergence_error", "jump_ok", "weak_symmetry_ok"]


def f_body(x):
    return np.stack(
        [
            0.7 * np.sin(1.5 * np.pi * x[..., 0])
            * 1.5 * np.cos(0.7 * np.pi * x[..., 1]),
            0.7 * np.cos(1.5 * np.pi * x[..., 0])
            * 1.5 * np.sin(0.7 * np.pi * x[..., 1]),
        ],
        -1,
    )


def g_flow(x):
    return (
        1.5 * np.sin(0.7 * np.pi * x[..., 0])
        * 1.5 * np.sin(0.7 * np.pi * x[..., 1])
    )[..., None]


def run(n=16, order=2, device=None, verbose=True, info=None):
    """The demo's flow on the hierarchy whose finest mesh is
    ``unit_square(n)``'s size (n a power of two times the coarse n).
    Returns the rows of the CSV: per field its divergence error and jump
    verdict, and the stress rows' weak-symmetry verdict.  ``info``: a dict
    that gets the stage seconds (``stages_s``), the MINRES ``iterations``,
    ``maxiter`` and ``residual``, the ``checks``, the solution dofs ``x``,
    the hierarchy ``meshes``, the equilibrator ``eq`` and ``cells``."""
    dev = resolve_device(device, "biot.run")
    st = Stages(dev)
    # nested red-refinement hierarchy: the primal solve rides a block
    # geometric-multigrid MINRES with mesh-independent iteration counts
    nlevels = max(1, int(np.log2(max(n // 4, 1))) + 1)
    meshes = st("mesh", lambda: mesh_hierarchy(
        unit_square(max(n >> (nlevels - 1), 1)), nlevels))
    msh = meshes[-1]
    Vu = FunctionSpace(msh, "P", order, vs=2)
    Vp = FunctionSpace(msh, "P", order)
    Vpt = FunctionSpace(msh, "P", order - 1)
    Vdg2 = FunctionSpace(msh, "DG", order - 1, vs=2)
    Vdg1 = FunctionSpace(msh, "DG", order - 1)

    # project the data into DG_{k-1} before the solve: the patch-ring
    # compatibility of the equilibration then holds exactly by Galerkin
    # orthogonality
    fe, ge = st("project_data", lambda: (
        local_projection(Vdg2, [expr_from_callable(f_body, msh, 2)],
                         quadrature_degree=2 * order + 6, device=dev)[0],
        local_projection(Vdg1, [expr_from_callable(g_flow, msh, 1)],
                         quadrature_degree=2 * order + 6, device=dev)[0]))
    solver = st("primal_setup", lambda: BiotSolverUPP(Vu, Vp, Vpt,
                                                      device=dev))
    uh, ph, pth = st("primal_solve", lambda: solver.solve(
        fe, ge, msh.boundary_facets, rtol=1e-12,
        mg=meshes if len(meshes) > 1 else None))
    if verbose:
        print(f"Biot primal (u-p-pt) solved ({solver.last_iterations} "
              f"block-MG MINRES iterations, residual "
              f"{solver.last_residual:.2e})")

    sigma_proj, rhs_proj = st("biot_fields", lambda: biot_fields(
        uh, ph, pth, fe, ge, order))
    eq = st("construct", lambda: FluxEqlbSE(
        order, msh, rhs_proj, sigma_proj, equilibrate_stress=True))
    st("set_bcs", lambda: eq.set_boundary_conditions(
        [msh.boundary_facets] * 3, [[], [], []]))
    st("equilibrate", eq.equilibrate_fluxes)

    checks = {}
    rows = []

    def run_checks():
        for i, name in enumerate(FIELDS):
            err, scale = divergence_error(eq.list_flux[i], sigma_proj[i],
                                          rhs_proj[i])
            checks[f"divergence_{i}"] = err < DIVERGENCE_ATOL * scale
            checks[f"jump_{i}"] = check_jump_condition(eq.list_flux[i],
                                                       sigma_proj[i])
            rows.append([name, err, checks[f"jump_{i}"]])
        checks["weak_symmetry"] = check_weak_symmetry_condition(
            eq.list_flux[:2], sigma_proj[:2])

    st("checks", run_checks)
    for r in rows:
        r.append(checks["weak_symmetry"] if r[0] != FIELDS[2] else "")
    if verbose:
        t_eq = st.s["construct"] + st.s["set_bcs"] + st.s["equilibrate"]
        print(f"3-field equilibration (2 stress rows + Darcy flux) in "
              f"{t_eq:.2f} s")
        for name, err, jump, _ in rows:
            print(f"  {name:<13}: divergence residual {err:.3e}, "
                  f"H(div)-conforming: {jump}")
        print(f"  weak symmetry of the stress rows: {checks['weak_symmetry']}")
    if info is not None:
        info.update(stages_s=st.s, iterations=solver.last_iterations,
                    maxiter=solver.last_maxiter,
                    residual=solver.last_residual, checks=checks,
                    x=(uh.x, ph.x, pth.x), meshes=meshes, eq=eq,
                    cells=msh.num_cells)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--order", type=int, default=2)
    p.add_argument("--outfile", default=None,
                   help="CSV of the checks (default Biot_n{n}_order{k}.csv)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    info = {}
    rows = run(a.n, a.order, device=a.device, info=info)
    out = a.outfile or f"Biot_n{a.n}_order{a.order}.csv"
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        w.writerows(rows)
    print(f"checks written to {out}")
    # the pressures at the vertices: P-space dofs 0 ... nv - 1
    msh = info["meshes"][-1]
    _, p_x, pt_x = info["x"]
    nv = msh.num_vertices
    write_xdmf("biot_pressure.xdmf", msh, {"p": p_x[:nv], "pt": pt_x[:nv]})
    print("pressures written to biot_pressure.xdmf")


if __name__ == "__main__":
    main()
