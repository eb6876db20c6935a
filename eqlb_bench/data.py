"""The benchmark's data: L load cases of DG_{k-1} dofs that every hat
function's compatibility condition accepts, made on the device from the
seed.

After ``tests/test_torch_kkt.py::_compatible_data`` (and the curl-field
data of ``dolfinx_eqlb_tpu_torch/bench.py``'s f64 mode): sigma_h is a
random member of the global, H(div)-conforming RT_{k-1} space, given as its
vector DG_{k-1} dofs, and f = div sigma_h.  Then

    int psi_z f + grad psi_z . sigma_h = int div(psi_z sigma_h) = 0

on every interior patch, as Galerkin orthogonality makes it for the data
of a primal solve.  The random DG dofs of ``bench.py``'s
``_make_data`` break that condition, and the semi-explicit and the KKT
modes then answer two different problems; on data that meets it, both
answer the one the plain reference solves.  The work per call does not
depend on the values.

The global dofs are drawn by a ``torch.Generator`` on the data's device in
one call, so a seed gives the same data on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.element import (
    dubiner_basis, gauss_triangle, poly_diff, poly_eval, rt_coeffs,
)
from .reference.kkt import cell_dofs
from .reference.topology import Topology


def _moments(k: int) -> tuple[np.ndarray, np.ndarray]:
    """(Phi (nrt, 2, ndg), Dq (nrt, ndg)): the reference-cell moments of the
    RT_{k-1} basis and of its divergence against the Dubiner modes of
    DG_{k-1}."""
    coeffs = rt_coeffs(k - 1)
    pts, w = gauss_triangle(2 * k)
    q = np.array([poly_eval(C, pts) for C in dubiner_basis(k - 1)])
    phi = np.array([[poly_eval(c, pts) for c in ci] for ci in coeffs])
    div = np.array([poly_eval(poly_diff(cx, 0), pts) + poly_eval(poly_diff(cy, 1), pts)
                    for cx, cy in coeffs])
    return (np.einsum("x,iax,mx->iam", w, phi, q),
            np.einsum("x,ix,mx->im", w, div, q))


def make_data(points: np.ndarray, topo: Topology, k: int, load_cases: int,
              seed: int, device, dtype=torch.float64):
    """(d_proj (L, nc, 2, ndg), d_rhs (L, nc, ndg)) on ``device``: the
    vector DG_{k-1} dofs of L random RT_{k-1} fields and the DG_{k-1} dofs
    of their divergence, in the Dubiner basis (dof m of a cell is the
    moment against its m-th orthonormal mode on the reference cell)."""
    if k < 2:
        raise ValueError("the data need RT_{k-1}: k >= 2")
    gd, sg = cell_dofs(topo, k - 1)
    ndofs = topo.num_facets * (k - 1) + topo.num_cells * (k - 1) * (k - 2)
    cells = topo.cells
    J = np.stack([points[cells[:, 1]] - points[cells[:, 0]],
                  points[cells[:, 2]] - points[cells[:, 0]]], axis=-1)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    Phi, Dq = _moments(k)

    def dev(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    xg = torch.randn((load_cases, ndofs), generator=gen, dtype=dtype,
                     device=device)
    c = xg[:, dev(gd, torch.int64)] * dev(sg) / dev(detJ)[:, None]  # (L, nc, nrt)
    d_proj = torch.einsum("lci,cab,ibm->lcam", c, dev(J), dev(Phi))
    d_rhs = torch.einsum("lci,im->lcm", c, dev(Dq))
    return d_proj.contiguous(), d_rhs.contiguous()
