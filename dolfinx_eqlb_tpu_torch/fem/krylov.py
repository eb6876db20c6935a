"""Matrix-free MINRES for the symmetric-indefinite primal problems.

Port of the JAX package's ``fem/krylov.py`` (the reference solves its
primal systems with PETSc; the matrix-free Krylov loop over batched per-cell
products stands in for it): preconditioned MINRES (Paige & Saunders) for
the mixed formulations (Herrmann elasticity; Biot).  The CG for SPD systems
sits in the solvers themselves (``models.poisson``, ``models.elasticity``).

As in the port's CG, the loop runs in Python with the reference's stopping
rule checked every iteration (one device-to-host read of the residual
estimate per iteration) and the reference's ``maxiter``.
"""

from __future__ import annotations

import torch

__all__ = ["minres"]


def minres(matvec, b, x0, Minv, free, rtol=1e-12, atol=1e-14, maxiter=1000,
           operands=None, chunk=None):
    """Preconditioned MINRES on the free dofs.

    ``matvec`` is the raw operator; essential dofs are handled by
    projection: the iteration runs on r0 = free * (b - A x0) and keeps the
    constrained components of x fixed at x0.  ``Minv`` is either a tensor
    (Jacobi: z = Minv * r) or a callable ``(r, operands) -> z`` applying a
    FIXED SPD operator on the free dofs (the Lanczos recurrence needs a
    linear preconditioner).  ``operands``: passed to ``matvec(v, operands)``
    and to a callable ``Minv``; without them ``matvec(v)`` is called.
    ``chunk`` is accepted for parity with the reference, where it bounds
    the iterations of one device dispatch, and ignored: this loop already
    runs on the host, so any ``chunk`` gives the same result as none.

    Returns the state dict: ``x``, ``phibar`` (the preconditioned residual
    norm, a 0-d tensor) and ``it`` (iterations, an int).  Stops when
    phibar <= rtol * (beta1 + atol) + atol or after ``maxiter`` iterations,
    beta1 being the preconditioned norm of r0."""
    def apply(v):
        return matvec(v) if operands is None else matvec(v, operands)

    if callable(Minv):
        def applyM(r):
            return Minv(r, operands)
    else:
        def applyM(r):
            return Minv * r

    free = torch.as_tensor(free, device=b.device)

    def Aop(v):
        return torch.where(free, apply(torch.where(free, v, 0.0)), 0.0)

    x = x0
    r = torch.where(free, b - apply(x0), 0.0)
    y = applyM(r)
    beta1 = torch.sqrt(torch.dot(r, y))
    beta, beta_old = beta1, 1.0
    r_old = torch.zeros_like(r)
    y_old = torch.zeros_like(r)
    w_old = torch.zeros_like(r)
    w_old2 = torch.zeros_like(r)
    dbar = epsln = sn = 0.0
    cs = -1.0
    phibar = beta1
    tol = rtol * (float(beta1) + atol) + atol
    it = 0
    while float(phibar) > tol and it < maxiter:
        v = y / beta
        Av = Aop(v)
        alfa = torch.dot(v, Av)
        ynew = applyM(Av) - (alfa / beta) * y - (beta / beta_old) * y_old
        rnew = Av - (alfa / beta) * r - (beta / beta_old) * r_old
        beta_new = torch.sqrt(torch.clamp(torch.dot(rnew, ynew), min=0.0)
                              + 1e-300)
        # QR via Givens
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta_new
        dbar = -cs * beta_new
        gamma = torch.sqrt(gbar ** 2 + beta_new ** 2) + 1e-300
        cs = gbar / gamma
        sn = beta_new / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w = (v - oldeps * w_old2 - delta * w_old) / gamma
        x = x + phi * w
        r_old, r = r, rnew
        y_old, y = y, ynew
        beta_old, beta = beta, beta_new
        w_old2, w_old = w_old, w
        it += 1
    return {"x": x, "phibar": phibar, "it": it}
