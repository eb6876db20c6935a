"""Demo: H(div)-conforming flux equilibration for a Poisson problem.

Port of the JAX package's ``demos/demo_reconstruction.py`` (reference
``demo/poisson/demo_reconstruction.py``): solve -div(grad u) = f with the
manufactured solution u = sin(2 pi x) cos(2 pi y), project flux/RHS,
equilibrate (SE or EV), check the equilibration conditions.

Run:  python -m dolfinx_eqlb_tpu_torch.demos.reconstruction [--eqlb SE|EV]
      [--degree k] [--bc dirichlet|neumann_hom|neumann_inhom] [--n 10]
      [--outdir DIR] [--device cpu]

``--outdir`` writes ``reconstruction.xdmf`` and ``reconstruction.vtu``
(the primal solution at the vertices, the projected and the
reconstructed flux at the cell midpoints) for ParaView.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..eqlb import (
    FluxEqlbEV,
    FluxEqlbSE,
    check_divergence_condition,
    check_jump_condition,
    fluxbc,
)
from ..fem import FunctionSpace, grad, local_projection, project_facet_trace
from ..fem.expressions import as_expr
from ..fem.spaces import resolve_device
from ..mesh import permute_vertices, unit_square
from ..models import PoissonSolver
from ..utils.io import flux_cell_values, write_vtu, write_xdmf

__all__ = ["exact_solution", "rhs", "ux", "solve_and_equilibrate",
           "write_output"]


def exact_solution(x):
    return np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def rhs(x):
    return 8 * np.pi**2 * exact_solution(x)


def ux(x):  # du/dx
    return 2 * np.pi * np.cos(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def solve_and_equilibrate(msh, order_prime, order_eqlb, bc_type, Equilibrator,
                          check=True, device=None, verbose=True, info=None):
    """Returns (uh, sigma_proj, equilibrator), all on ``device`` (the CUDA
    card by default).  ``info``: a dict that gets the primal solve's CG
    iterations (``"cg_iterations"``)."""
    dev = resolve_device(device, "solve_and_equilibrate")
    k = order_eqlb
    V = FunctionSpace(msh, "P", order_prime)
    Vr = FunctionSpace(msh, "DG", k - 1)
    Vf = FunctionSpace(msh, "DG", k - 1, vs=2)

    left = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 0.0))
    right = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 1.0))
    bot = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 1], 0.0))
    top = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 1], 1.0))

    rhs_proj = local_projection(Vr, [rhs], quadrature_degree=2 * k + 8,
                                device=dev)
    solver = PoissonSolver(V, device=dev)
    if bc_type == "dirichlet":
        fcts_prime, bcs, neumann = msh.boundary_facets, [], None
    elif bc_type == "neumann_hom":
        fcts_prime = np.concatenate([bot, top])
        bcs = [fluxbc(0.0, np.concatenate([left, right]))]
        neumann = None  # u_x = 0 on x in {0, 1} for this solution
    else:  # neumann_inhom on x in {0,1}: share the projected trace data
        fcts_prime = np.concatenate([bot, top])
        gl = project_facet_trace(msh, left, lambda x: -ux(x), k)
        gr = project_facet_trace(msh, right, ux, k)
        neumann = [(left, gl), (right, gr)]
        bcs = [fluxbc(-gl, left), fluxbc(-gr, right)]  # sigma.n = -grad(u).n

    t0 = time.perf_counter()
    uh = solver.solve(rhs_proj[0], fcts_prime, exact_solution, neumann=neumann,
                      rtol=1e-13)
    if info is not None:
        info["cg_iterations"] = solver.last_iterations
    if verbose:
        print(f"Primal problem solved in {time.perf_counter()-t0:.4e} s "
              f"({solver.last_iterations} CG iterations)")

    sigma_proj = local_projection(Vf, [-1.0 * grad(uh)])
    eq = Equilibrator(k, msh, rhs_proj, sigma_proj)
    eq.set_boundary_conditions([fcts_prime], [bcs])
    t0 = time.perf_counter()
    eq.equilibrate_fluxes()
    if verbose:
        print(f"Equilibration solved in {time.perf_counter()-t0:.4e} s")

    if check:
        assert check_divergence_condition(
            eq.list_flux[0], sigma_proj[0], rhs_proj[0]
        ), "Divergence conditions not fulfilled"
        if Equilibrator is FluxEqlbSE:
            assert check_jump_condition(
                eq.list_flux[0], sigma_proj[0]
            ), "Jump conditions not fulfilled"
        if verbose:
            print("Equilibration conditions fulfilled")
    return uh, sigma_proj[0], eq


def write_output(outdir, msh, uh, sigma_proj, eq):
    """XDMF/VTU export for ParaView (reference
    ``demo/poisson/demo_reconstruction.py:534-540``): the primal solution
    at the vertices (corner values, averaged over the cells that share a
    vertex), the projected and the reconstructed flux at the cell
    midpoints."""
    os.makedirs(outdir, exist_ok=True)
    corners = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    uv = as_expr(uh).evaluate(corners).cpu().numpy()  # (nc, 3, 1)
    num = np.zeros(msh.num_vertices)
    cnt = np.zeros(msh.num_vertices)
    np.add.at(num, msh.cells.reshape(-1), uv.reshape(-1))
    np.add.at(cnt, msh.cells.reshape(-1), 1.0)
    point_data = {"u": num / np.maximum(cnt, 1.0)}
    cell_data = {
        "sigma_proj": flux_cell_values(sigma_proj),
        "sigma_R": flux_cell_values(eq.list_flux[0], sigma_proj),
    }
    write_xdmf(os.path.join(outdir, "reconstruction.xdmf"), msh,
               point_data, cell_data)
    write_vtu(os.path.join(outdir, "reconstruction.vtu"), msh,
              point_data, cell_data)
    print(f"ParaView output written to {outdir}/reconstruction.{{xdmf,vtu}}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--eqlb", default="SE", choices=["SE", "EV"])
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--order-prime", type=int, default=1)
    p.add_argument("--bc", default="dirichlet",
                   choices=["dirichlet", "neumann_hom", "neumann_inhom"])
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--reversed-mesh", action="store_true")
    p.add_argument("--outdir", default=None,
                   help="write XDMF/VTU ParaView output to this directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    msh = unit_square(a.n)
    if a.reversed_mesh:
        msh = permute_vertices(msh, seed=1)
    Eq = FluxEqlbSE if a.eqlb == "SE" else FluxEqlbEV
    uh, sp, eq = solve_and_equilibrate(msh, a.order_prime, a.degree, a.bc,
                                       Eq, device=a.device)
    if a.outdir:
        write_output(a.outdir, msh, uh, sp, eq)


if __name__ == "__main__":
    main()
