"""Equilibrated a-posteriori error estimator for the Poisson problem.

Port of the JAX package's ``estimation/poisson.py``: the Ern-Vohralik
estimator (reference ``demo/poisson/demo_error_estimation.py:52-125``),
per cell  eta_c = eta_sig,c + eta_osc,c with

    eta_sig,c = || sigma_R + grad(u_h) ||_c        (EV, conforming flux)
              = || corrector ||_c                   (SE; exact when the
                projection degree resolves grad u_h, see reference :96-101)
    eta_osc,c = (h_c / pi) || f - div sigma_R ||_c

and the guaranteed total  eta^2 = sum_c (eta_sig,c + eta_osc,c)^2.

Computed on the device of ``uh``'s dofs; the exact right-hand side is a
host callable (at ``mesh.map_points``), uploaded there.
"""

from __future__ import annotations

import math

import torch

from ..fem.assemble import cell_integrals_sq
from ..fem.expressions import Expr, as_expr, cell_scale, grad
from ..fem.spaces import Function

__all__ = ["estimate_poisson"]


def estimate_poisson(
    f,
    uh: Function,
    sigma_eq: Function,
    sigma_proj: Function | None = None,
    quadrature_degree: int | None = None,
    coefficient=None,
):
    """Returns (eta_total, eta_sig, eta_osc, cell_eta_sq): three Python
    floats and a (ncells,) f64 tensor on ``uh``'s device.

    ``f`` is the exact right-hand side (expression/callable).  For the SE
    equilibrator pass the corrector as ``sigma_eq`` and the projected flux as
    ``sigma_proj``; for EV pass the conforming flux and sigma_proj=None.

    ``coefficient``: optional cell-wise diffusion kappa (for
    -div(kappa grad u) = f): the estimator measures in the energy norm
    kappa^{-1/2}-weighted (Kellogg checkerboard demo,
    reference ``poisson_adaptive/demo_discont-coeff.py``).
    """
    msh = uh.space.mesh
    dev = uh.device
    k = sigma_eq.space.degree
    qdeg = quadrature_degree or (2 * k + 10)

    if sigma_eq.space.family == "RT":  # EV
        err_sig = as_expr(sigma_eq) + grad(uh)
        sig_R = as_expr(sigma_eq)
    else:  # SE: reconstructed flux = corrector + projected flux
        err_sig = as_expr(sigma_eq)
        sig_R = as_expr(sigma_eq) + as_expr(sigma_proj)
    if coefficient is not None:
        kap = torch.as_tensor(coefficient, dtype=torch.float64, device=dev)
        if sigma_eq.space.family == "RT":
            err_sig = as_expr(sigma_eq) + cell_scale(grad(uh), kap)

    eta_sig2 = cell_integrals_sq(err_sig, qdeg, device=dev)
    osc = as_expr(f, msh) - _div_expr(sig_R)
    h = torch.as_tensor(msh.h_cell, dtype=torch.float64, device=dev)
    eta_osc2 = (h / math.pi) ** 2 * cell_integrals_sq(osc, qdeg, device=dev)
    if coefficient is not None:
        eta_sig2 = eta_sig2 / kap
        eta_osc2 = eta_osc2 / kap

    cell_eta_sq = (torch.sqrt(eta_sig2) + torch.sqrt(eta_osc2)) ** 2
    eta = float(torch.sqrt(cell_eta_sq.sum()))
    return (
        eta,
        float(torch.sqrt(eta_sig2.sum())),
        float(torch.sqrt(eta_osc2.sum())),
        cell_eta_sq,
    )


class _DivWrap(Expr):
    """The divergence of a vector expression, as a scalar expression."""

    def __init__(self, e):
        self.e = e
        self.mesh = e.mesh
        self.value_size = 1
        self.device = e.device

    def evaluate(self, q):
        return self.e.evaluate_div(q)


def _div_expr(e):
    return _DivWrap(e)
