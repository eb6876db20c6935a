"""Post-hoc verification of the equilibration conditions.

Port of the JAX package's ``eqlb/checks.py`` (the reference's
``eqlb/check_eqlb_conditions.py``): divergence condition, jump
(H(div)-conformity) condition — both as an interpolation residual and per
facet — boundary conditions, and the weak symmetry condition.  The
evaluations run on the device of the checked Functions; each check reduces
to a host number or boolean.
"""

from __future__ import annotations

import numpy as np
import torch

from ..elements.quadrature import facet_param_points, gauss_triangle
from ..fem.spaces import (
    Function, mesh_geometry, mesh_space, space_tables, tabulation,
)
from ..fem.expressions import as_expr
from ..fem.interpolate import interpolate
from ..fem.assemble import cell_integrals_sq

__all__ = [
    "mesh_has_reversed_edges",
    "reconstructed_flux_expr",
    "check_divergence_condition",
    "check_jump_condition",
    "check_jump_condition_per_facet",
    "check_boundary_conditions",
    "check_weak_symmetry_condition",
]


def mesh_has_reversed_edges(mesh) -> bool:
    """True if any interior facet runs anti-aligned in one of its cells
    (reference ``check_eqlb_conditions.py:19-86`` via facet permutations;
    here the orientation bit is explicit in the topology)."""
    f = ~mesh.is_boundary_facet
    a0 = mesh.edge_aligned[mesh.facet_cells[f, 0], mesh.facet_local[f, 0]]
    a1 = mesh.edge_aligned[mesh.facet_cells[f, 1], mesh.facet_local[f, 1]]
    bf = mesh.boundary_facets
    ab = mesh.edge_aligned[mesh.facet_cells[bf, 0], mesh.facet_local[bf, 0]]
    return bool((a0 != a1).any() or (~ab).any())


def reconstructed_flux_expr(sigma_eq: Function, sigma_proj: Function):
    """sigma_R: the flux itself (EV / conforming RT) or corrector + projected
    flux (SE / discontinuous RT), cf. reference ``FluxEqlbSE.py:176-186``."""
    if sigma_eq.space.family == "RT":
        return as_expr(sigma_eq)
    return as_expr(sigma_eq) + as_expr(sigma_proj)


# the checks' default tolerances, as in the reference
DIVERGENCE_ATOL = 1e-8
JUMP_ATOL = 1e-12


def divergence_error(sigma_eq: Function, sigma_proj: Function,
                     rhs_proj: Function) -> tuple[float, float]:
    """max |div(sigma_R) - projected RHS| over every cell's quadrature
    points, and the scale max |projected RHS| + 1 that the divergence
    check's tolerance multiplies."""
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    k = sigma_eq.space.degree
    pts, _ = gauss_triangle(2 * k + 2)
    dv = sig.evaluate_div(pts)[..., 0]
    rv = as_expr(rhs_proj).evaluate(pts)[..., 0].to(dv.device)
    err = float(torch.max(torch.abs(dv - rv)))
    return err, float(torch.max(torch.abs(rv))) + 1.0


def check_divergence_condition(
    sigma_eq: Function,
    sigma_proj: Function,
    rhs_proj: Function,
    atol: float = DIVERGENCE_ATOL,
    return_error: bool = False,
):
    """div(sigma_R) == projected RHS, checked at quadrature points per cell
    (reference ``check_eqlb_conditions.py:183-291`` point-evaluates on a
    random test set; a quadrature lattice is equivalent and deterministic).
    """
    err, scale = divergence_error(sigma_eq, sigma_proj, rhs_proj)
    if return_error:
        return err
    return err < atol * scale


def jump_error(sigma_eq: Function, sigma_proj: Function) -> float:
    """The squared H(div) distance between sigma_R and its conforming-RT
    interpolant, summed over the cells."""
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    dev = sigma_eq.device
    msh = sigma_eq.space.mesh
    k = sigma_eq.space.degree
    interp = interpolate(mesh_space(msh, "RT", k), sig, device=dev)
    err = as_expr(interp) - sig
    e2 = cell_integrals_sq(err, 2 * k + 2, device=dev)
    # divergence part
    pts, w = gauss_triangle(2 * k + 2)
    dv = err.evaluate_div(pts)[..., 0]
    adet = mesh_geometry(msh, dev)["detJ"].abs()
    w = torch.as_tensor(w, dtype=dv.dtype, device=dev)
    e2 = e2 + adet * torch.einsum("q,cq,cq->c", w, dv, dv)
    return float(e2.sum())


def check_jump_condition(
    sigma_eq: Function, sigma_proj: Function, atol: float = JUMP_ATOL,
    return_error: bool = False,
):
    """H(div)-conformity via the interpolation residual: sigma_R must equal
    its conforming-RT interpolant in the H(div) norm (reference
    ``check_eqlb_conditions.py:294-359``).  ``return_error`` returns the
    squared residual instead of the verdict."""
    err = jump_error(sigma_eq, sigma_proj)
    if return_error:
        return err
    return err < atol


def check_jump_condition_per_facet(
    sigma_eq: Function, sigma_proj: Function, atol: float = 1e-9
):
    """Pointwise two-sided normal-trace comparison on every interior facet
    (reference ``check_eqlb_conditions.py:362-473``); host NumPy after one
    download of the evaluated traces."""
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    msh = sigma_eq.space.mesh
    k = sigma_eq.space.degree
    s = np.linspace(0.0, 1.0, k + 4)[1:-1]
    pts_e = facet_param_points(s)
    # (3, nc, nq, 2): flux values on each local edge's parameter lattice
    V = torch.stack([sig.evaluate(pts_e[e]) for e in range(3)]).cpu().numpy()
    scale = float(np.max(np.abs(V))) + 1.0
    fint = np.where(msh.facet_cells[:, 1] >= 0)[0]
    if len(fint) == 0:
        return True
    T = msh.facet_tangent[fint]
    rotT = np.stack([T[:, 1], -T[:, 0]], axis=1)
    rotT /= np.linalg.norm(rotT, axis=1, keepdims=True)
    traces = []
    for side in (0, 1):
        c = msh.facet_cells[fint, side]
        e = msh.facet_local[fint, side]
        v = V[e, c]  # (nfint, nq, 2)
        rev = ~msh.edge_aligned[c, e]
        v = np.where(rev[:, None, None], v[:, ::-1], v)
        traces.append(np.einsum("fqa,fa->fq", v, rotT))
    return bool(np.allclose(traces[0], traces[1], atol=atol * scale))


def check_boundary_conditions(
    sigma_eq: Function,
    sigma_proj: Function,
    boundary_function: Function,
    boundary_facets: np.ndarray,
    atol: float = 1e-9,
):
    """Facet dofs of sigma_R on the given boundary facets must equal the BC
    function's dofs (reference ``check_eqlb_conditions.py:90-179``)."""
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    V_rt = boundary_function.space
    if V_rt.family != "RT":
        raise ValueError("the boundary function must be RT")
    interp = interpolate(V_rt, sig, device=sigma_eq.device)
    k = V_rt.degree
    fcts = np.asarray(boundary_facets, dtype=np.int64)
    idx = (fcts[:, None] * k + np.arange(k)[None, :]).ravel()
    a = interp.x[torch.as_tensor(idx, device=interp.device)].cpu().numpy()
    b = boundary_function.x[
        torch.as_tensor(idx, device=boundary_function.device)].cpu().numpy()
    scale = float(np.max(np.abs(b))) + 1.0
    return bool(np.allclose(a, b, atol=atol * scale))


def check_weak_symmetry_condition(list_sigma_eq, list_sigma_proj=None, atol=1e-9):
    """(sigma_01 - sigma_10, v) == 0 for all v in continuous P1 (reference
    ``check_eqlb_conditions.py:476-521``). Row i of the stress is flux i."""
    s0 = list_sigma_eq[0]
    msh = s0.space.mesh
    dev = s0.device
    if list_sigma_proj is None:
        rows = [as_expr(s) for s in list_sigma_eq]
    else:
        rows = [
            reconstructed_flux_expr(se, sp)
            for se, sp in zip(list_sigma_eq, list_sigma_proj)
        ]
    k = s0.space.degree
    pts, w = gauss_triangle(2 * k + 2)
    v01 = rows[0].evaluate(pts)[..., 1].to(dev)
    v10 = rows[1].evaluate(pts)[..., 0].to(dev)
    V1 = mesh_space(msh, "P", 1)
    tab = tabulation(V1, pts, dev)  # (3, nq)
    adet = mesh_geometry(msh, dev)["detJ"].abs()
    w = torch.as_tensor(w, dtype=v01.dtype, device=dev)
    be = adet[:, None] * torch.einsum("q,cq,iq->ci", w, v01 - v10, tab)
    L = be.new_zeros(V1.ndofs).index_add_(
        0, space_tables(V1, dev)["cell_dofs"].reshape(-1), be.reshape(-1))
    scale = float(torch.max(adet)) + 1.0
    return bool(np.allclose(L.cpu().numpy(), 0.0, atol=atol * scale))
