"""Guaranteed error estimator for linear elasticity with weakly symmetric
equilibrated stresses.

Port of the JAX package's ``estimation/elasticity.py`` (reference
``demo/elasticity/demo_error_estimation.py:60-149``).  With the corrector
tensor Delta_sigma (rows = SE correctors of the negated stress rows), Korn
constants C_K and pi_1 = lambda/mu:

    eta_sig,c^2  = int_c Delta_sigma : A(Delta_sigma),
                   A(t) = 0.5 (t - pi_1/(2+2 pi_1) tr(t) I)
    eta_wsym,c   = 0.5 C_K || Delta_sigma_01 - Delta_sigma_10 ||_c
    eta_osc,c    = C_K (h_c/pi) || f + div(sigma_h + Delta_sigma) ||_c

guaranteed bound:  eta^2 = sum eta_sig^2 + sum (eta_osc + eta_wsym)^2
(+ the C_a-weighted div/pressure mismatch for the displacement-pressure
formulation, reference :113-119).  Computed on the device of the
correctors; the exact body force is a host callable, uploaded there.
"""

from __future__ import annotations

import math

import torch

from ..elements.quadrature import gauss_triangle
from ..fem.expressions import as_expr
from ..fem.spaces import Function, mesh_geometry

__all__ = ["estimate_elasticity"]


def estimate_elasticity(
    f_rows,
    pi_1: float,
    sigma_proj_rows,
    corrector_rows,
    korn_constants: Function,
    quadrature_degree: int | None = None,
    guaranteed_upper_bound: bool = True,
    pressure_term=None,
):
    """Returns (eta_total, [eta_sig, eta_wsym, eta_osc], cell_eta_sq): a
    Python float, a list of three and a (ncells,) f64 tensor on the
    correctors' device.

    ``f_rows``: exact body-force rows (with the sign convention used for the
    equilibration: div(sigma_row) = f_row); ``pressure_term``: optional
    per-cell expression ``div(u_h) - p_h / pi_1`` for the Herrmann
    formulation.
    """
    msh = korn_constants.space.mesh
    dev = corrector_rows[0].device
    k = corrector_rows[0].space.degree
    qdeg = quadrature_degree or (2 * k + 10)
    pts, w = gauss_triangle(qdeg)
    wj = torch.as_tensor(w, device=dev)
    adet = mesh_geometry(msh, dev)["detJ"].abs()

    # corrector tensor rows at quadrature: (nc, nq, 2) each
    d0 = corrector_rows[0].evaluate(pts)
    d1 = corrector_rows[1].evaluate(pts)
    trace = d0[..., 0] + d1[..., 1]
    c = pi_1 / (2.0 + 2.0 * pi_1)
    # Delta : A(Delta) = 0.5 (|Delta|^2 - c tr(Delta)^2)
    dd = (torch.einsum("cqa,cqa->cq", d0, d0)
          + torch.einsum("cqa,cqa->cq", d1, d1))
    eta_sig2 = 0.5 * adet * torch.einsum("q,cq->c", wj, dd - c * trace ** 2)

    ck = korn_constants.evaluate(pts)[..., 0].to(dev)  # (nc, nq)
    wsym = d0[..., 1] - d1[..., 0]
    eta_wsym2 = 0.25 * adet * torch.einsum("q,cq,cq->c", wj, ck * wsym,
                                           ck * wsym)

    h = torch.as_tensor(msh.h_cell, dtype=torch.float64, device=dev)
    osc2 = torch.zeros(msh.num_cells, dtype=torch.float64, device=dev)
    for j in range(2):
        sig_row = as_expr(corrector_rows[j]) + as_expr(sigma_proj_rows[j])
        res = (as_expr(f_rows[j], msh).evaluate(pts)[..., 0].to(dev)
               - sig_row.evaluate_div(pts)[..., 0].to(dev))
        osc2 = osc2 + adet * torch.einsum("q,cq,cq->c", wj, ck * res,
                                          ck * res)
    eta_osc2 = (h / math.pi) ** 2 * osc2

    cell_eta_sq = eta_sig2
    if pressure_term is not None:
        ck0 = ck[:, 0]
        ca2 = ((2 * pi_1) / (1 + pi_1)) * (
            1 + (pi_1 / (1 + pi_1)) * (ck0 ** 2 - 9.0)
        )
        pv = as_expr(pressure_term).evaluate(pts)[..., 0].to(dev)
        cell_eta_sq = cell_eta_sq + ca2 * adet * torch.einsum(
            "q,cq,cq->c", wj, pv, pv)
    if guaranteed_upper_bound:
        cell_eta_sq = cell_eta_sq + (torch.sqrt(eta_osc2)
                                     + torch.sqrt(eta_wsym2)) ** 2
    else:
        cell_eta_sq = cell_eta_sq + eta_osc2

    eta = float(torch.sqrt(cell_eta_sq.sum()))
    comps = [
        float(torch.sqrt(eta_sig2.sum())),
        float(torch.sqrt(eta_wsym2.sum())),
        float(torch.sqrt(eta_osc2.sum())),
    ]
    return eta, comps, cell_eta_sq
