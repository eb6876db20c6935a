"""Flux boundary conditions.

Port of the JAX package's ``eqlb/bcs.py``: host NumPy, copied, apart from
``boundary_function``, which returns a Function on a device.  It replaces
the reference BC pipeline (``python/dolfinx_eqlb/eqlb/bcs.py`` +
``base/FluxBC.hpp`` + ``base/BoundaryData.cpp:278-633``): a ``fluxbc``
prescribes the outward normal trace sigma.n = g on a set of boundary facets;
``boundarydata`` evaluates, for every such facet, the k Legendre facet-dof
moments of g (the facet-local L2 projection of the trace — with Legendre
moments the reference's projection-vs-interpolation distinction
(``bcs.py:64-121``) collapses to the choice of quadrature degree).  The
per-patch hat-weighted boundary dofs (reference
``BoundaryData::calculate_patch_bc``, ``BoundaryData.cpp:635-745``) are then
a tiny einsum inside the engine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..elements.polynomials import legendre_shifted
from ..elements.quadrature import gauss_interval
from ..fem.spaces import Function, FunctionSpace

__all__ = ["fluxbc", "FluxBC", "boundarydata", "BoundaryData",
           "boundary_function"]


@dataclass
class FluxBC:
    """One group of flux BCs: sigma.n = value on the given boundary facets.

    ``value`` is a callable ``g(x) -> (...,)`` at physical points.  The
    ``requires_projection`` flag of the reference maps to choosing a
    quadrature degree high enough to resolve non-polynomial data.
    """

    value: object
    facets: np.ndarray
    quadrature_degree: int | None = None
    is_zero: bool = False


def fluxbc(value, facets, V_flux=None, requires_projection=False, quadrature_degree=None) -> FluxBC:
    """Create a flux BC (API mirror of reference ``bcs.py:25-162``).

    ``value``: a constant, a callable at physical points, or an array of
    per-facet shifted-Legendre trace coefficients (nfacets, m) as produced by
    ``fem.project_facet_trace`` (row order must match ``facets``).
    """
    if isinstance(value, (int, float)):
        c = float(value)
        return FluxBC(
            lambda x, c=c: c * np.ones(x.shape[:-1]),
            np.asarray(facets, dtype=np.int64),
            quadrature_degree,
            is_zero=(c == 0.0),
        )
    return FluxBC(value, np.asarray(facets, dtype=np.int64), quadrature_degree)


class BoundaryData:
    """Facet classification + flux-BC dof values for every RHS.

    facet_kind (n_rhs, nf) int8: 0 interior/outer, 1 flux-free (primal
    Dirichlet boundary), 2 flux-essential.  bvals (n_rhs, nf, k) holds the
    Legendre facet dof values L_m(g) of the prescribed trace.  Both are
    full-width for indexing by facet id, but ``EqlbEngine.equilibrate``
    reads (and from host arrays uploads) only the rows of the boundary
    facets: interior rows are ignored, whatever they hold.
    """

    def __init__(self, mesh, degree: int, n_rhs: int):
        self.mesh = mesh
        self.k = degree
        self.facet_kind = np.zeros((n_rhs, mesh.num_facets), dtype=np.int8)
        # boundary facets default to flux-free unless marked
        self.facet_kind[:, mesh.boundary_facets] = 1
        self.bvals = np.zeros((n_rhs, mesh.num_facets, degree))


def _facet_moments(mesh, facets: np.ndarray, g, qdeg: int, k: int) -> np.ndarray:
    """Legendre facet dofs L_m(sigma) for sigma.n_out = g on given facets.

    L_m = sign_out * |T| * int_0^1 g(X(s)) P~_m(s) ds  along the canonical
    facet direction (see fem.dofmap conventions).
    """
    nq = max(k + 1, (qdeg + 2) // 2)
    s, w = gauss_interval(nq)
    leg = legendre_shifted(k - 1)
    legv = np.array([np.polyval(leg[m, ::-1], s) for m in range(k)])
    lo = mesh.points[mesh.facet_vertices[facets, 0]]
    T = mesh.facet_tangent[facets]
    xq = lo[:, None, :] + np.einsum("q,fa->fqa", s, T)
    gv = np.asarray(g(xq))  # (nfacets, nq)
    # sigma . rot(T) = sign_out * |T| * (sigma . n_out) along the facet
    sgn = mesh.boundary_outward_sign[facets] * mesh.facet_length[facets]
    return sgn[:, None] * np.einsum("q,mq,fq->fm", w, legv, gv)


def boundarydata(
    list_bcs: list[list[FluxBC]],
    V_flux: FunctionSpace,
    list_bfct_prime: list[np.ndarray],
    quadrature_degree: int | None = None,
) -> BoundaryData:
    """Build BoundaryData from per-RHS lists of flux BCs and primal-Dirichlet
    facets (reference ``bcs.py:165-215`` + ``BoundaryData.cpp:413-633``).

    Every boundary facet must be flux-free (primal Dirichlet) or carry a flux
    BC; unmarked boundary facets default to flux-free.
    """
    mesh = V_flux.mesh
    k = V_flux.degree
    n_rhs = len(list_bcs)
    if len(list_bfct_prime) != n_rhs:
        raise ValueError("mismatching inputs")
    bd = BoundaryData(mesh, k, n_rhs)
    for i, bcs in enumerate(list_bcs):
        for bc in bcs:
            fcts = np.asarray(bc.facets, dtype=np.int64)
            if not np.all(mesh.is_boundary_facet[fcts]):
                raise ValueError("flux BC on non-boundary facet")
            bd.facet_kind[i, fcts] = 2
            if not bc.is_zero:
                if isinstance(bc.value, np.ndarray):
                    # Legendre trace coefficients: L_m = sign |T| alpha_m/(2m+1)
                    coef = bc.value[:, :k] if bc.value.shape[1] >= k else np.pad(
                        bc.value, ((0, 0), (0, k - bc.value.shape[1]))
                    )
                    sgn = (
                        mesh.boundary_outward_sign[fcts] * mesh.facet_length[fcts]
                    )
                    bd.bvals[i, fcts] = (
                        sgn[:, None] * coef / (2.0 * np.arange(k) + 1.0)
                    )
                else:
                    qdeg = bc.quadrature_degree or quadrature_degree or (2 * k + 2)
                    bd.bvals[i, fcts] = _facet_moments(mesh, fcts, bc.value, qdeg, k)
        # primal facets are flux-free; flag conflicts
        pf = np.asarray(list_bfct_prime[i], dtype=np.int64)
        if np.any(bd.facet_kind[i, pf] == 2):
            raise ValueError("facet marked both primal-Dirichlet and flux BC")
        bd.facet_kind[i, pf] = 1
    return bd


def boundary_function(bd: BoundaryData, i_rhs: int, V_flux: FunctionSpace,
                      device=None) -> Function:
    """RT function whose flux-essential facet dofs carry the BC values
    (the reference's ``list_bfunctions``, used by the BC checker), on
    ``device`` (the CUDA card by default)."""
    k = V_flux.degree
    x = np.zeros(V_flux.ndofs)
    fcts = np.where(bd.facet_kind[i_rhs] == 2)[0]
    for m in range(k):
        x[fcts * k + m] = bd.bvals[i_rhs, fcts, m]
    return Function(V_flux, x, device=device)
