"""The port's estimation and adaptivity layer against the JAX package's, on
the CPU: the host pieces (``lshape``, ``refine_uniform``, ``refine_marked``,
``refine_facets``, ``doerfler_mark``) must give identical arrays, and
``estimate_poisson`` must agree on the same inputs.

The estimator gets the JAX flow's uh, projected flux and equilibrated
fluxes (``demo_reconstruction``'s Dirichlet flow on ``unit_square(3)`` and
its ``permute_vertices`` copy, k = 1-3), their dofs copied into the port's
Functions, so that only the estimator is compared: ``cell_eta_sq`` within
1e-12 * max, the three totals within 1e-12 relative.  One JAX engine per
(mesh, k) serves both equilibrators."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import eqlb as jeqlb
from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.equilibrators import _mesh_patches as jax_patches
from dolfinx_eqlb_tpu.estimation import doerfler_mark as jax_mark
from dolfinx_eqlb_tpu.estimation import estimate_poisson as jax_estimate
from dolfinx_eqlb_tpu.mesh import generators as jgen
from dolfinx_eqlb_tpu.mesh import refine as jref
from dolfinx_eqlb_tpu.models import PoissonSolver as JaxPoisson

from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.estimation import doerfler_mark, estimate_poisson
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen
from dolfinx_eqlb_tpu_torch.mesh import refine as tref

torch.set_num_threads(2)

_MESH_ATTRS = [
    "points", "cells", "num_cells", "num_vertices", "num_facets",
    "facet_vertices", "cell_facets", "facet_cells", "facet_local",
    "edge_aligned", "is_boundary_facet", "boundary_facets", "v2c_offsets",
    "v2c_data", "v2f_offsets", "v2f_data", "is_boundary_vertex", "J",
    "detJ", "K", "cell_volumes", "facet_tangent", "facet_length", "h_cell",
    "boundary_outward_sign",
]

_BASE = {
    "lshape2": lambda g: g.lshape(2),
    "permuted3": lambda g: g.permute_vertices(g.unit_square(3), seed=5),
}


def _assert_same_mesh(jm, tm):
    for attr in _MESH_ATTRS:
        a, b = np.asarray(getattr(jm, attr)), np.asarray(getattr(tm, attr))
        assert a.dtype == b.dtype, attr
        np.testing.assert_array_equal(a, b, err_msg=attr)


# --- host pieces ------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3])
def test_lshape_identical(n):
    jm, tm = jgen.lshape(n), tgen.lshape(n)
    _assert_same_mesh(jm, tm)
    assert np.isclose(tm.cell_volumes.sum(), 3.0)


@pytest.mark.parametrize("base", sorted(_BASE))
def test_refine_uniform_identical(base):
    jm, tm = _BASE[base](jgen), _BASE[base](tgen)
    for _ in range(2):
        jm, tm = jref.refine_uniform(jm), tref.refine_uniform(tm)
        _assert_same_mesh(jm, tm)


@pytest.mark.parametrize("base", sorted(_BASE))
def test_longest_edge_identical(base):
    jm, tm = _BASE[base](jgen), _BASE[base](tgen)
    np.testing.assert_array_equal(jref._longest_edge(jm),
                                  tref._longest_edge(tm))


@pytest.mark.parametrize("base", sorted(_BASE))
def test_refine_marked_identical(base):
    """Five rounds of seeded random marking, propagation included."""
    jm, tm = _BASE[base](jgen), _BASE[base](tgen)
    rng = np.random.default_rng(7)
    for _ in range(5):
        marked = rng.choice(tm.num_cells, size=max(1, tm.num_cells // 5),
                            replace=False)
        jm, tm = jref.refine_marked(jm, marked), tref.refine_marked(tm, marked)
        _assert_same_mesh(jm, tm)


@pytest.mark.parametrize("base", sorted(_BASE))
def test_refine_split_no_propagation_identical(base):
    """``_refine_split(propagate=False)``, the path ``refine_facets`` takes,
    on every third facet, and ``refine_facets`` itself on the boundary."""
    jm, tm = _BASE[base](jgen), _BASE[base](tgen)
    split = np.zeros(tm.num_facets, dtype=bool)
    split[::3] = True
    _assert_same_mesh(jref._refine_split(jm, split.copy(), propagate=False),
                      tref._refine_split(tm, split.copy(), propagate=False))
    _assert_same_mesh(jref.refine_facets(jm, jm.boundary_facets),
                      tref.refine_facets(tm, tm.boundary_facets))


def test_refine_marked_deep_corner_identical():
    """The deep-corner case of ``tests/test_mesh.py``: 60 rounds of marking
    the cells at the re-entrant corner reach h < 1e-8; both packages give
    the same mesh every round (the relative tie-break of ``_longest_edge``
    and the relative degeneracy guard of ``TriMesh``)."""
    jm, tm = jgen.lshape(2), tgen.lshape(2)
    corner = np.array([0.0, 0.0])
    for _ in range(60):
        d = np.linalg.norm(tm.points[tm.cells].mean(axis=1) - corner, axis=-1)
        marked = np.where(d <= d.min() * (1 + 1e-9))[0]
        jm, tm = jref.refine_marked(jm, marked), tref.refine_marked(tm, marked)
        np.testing.assert_array_equal(jm.cells, tm.cells)
        np.testing.assert_array_equal(jm.points, tm.points)
    _assert_same_mesh(jm, tm)
    assert tm.h_cell.min() < 1e-8
    assert (tm.cell_volumes / tm.h_cell**2).min() > 0.05


def _eta_with_ties(seed=3, n=200):
    """Seeded indicators with planted ties: groups of equal values, and
    values equal up to the last bit (mirror cells of a symmetric mesh)."""
    rng = np.random.default_rng(seed)
    eta = rng.random(n) ** 4
    eta[10:20] = eta[5]
    eta[40:60:2] = eta[41]
    eta[100:110] = np.nextafter(eta[99], 1.0)
    eta[150:153] = eta.max()
    return eta


@pytest.mark.parametrize("theta", [0.3, 0.5, 0.6])
def test_doerfler_mark_identical(theta):
    eta = _eta_with_ties()
    want = np.asarray(jax_mark(eta, theta))
    got = doerfler_mark(eta, theta)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # a tensor gives the same cells
    np.testing.assert_array_equal(doerfler_mark(torch.as_tensor(eta), theta),
                                  want)
    assert eta[got].sum() >= theta * eta.sum()


# --- the estimator ------------------------------------------------------------

_MESHES = {
    "crossed": lambda g: g.unit_square(3),
    "permuted": lambda g: g.permute_vertices(g.unit_square(3), seed=13),
}


def _u(x):
    return np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def _f(x):
    return 8 * np.pi**2 * _u(x)


@pytest.fixture(scope="module")
def flows():
    """flows(mesh, k) -> the JAX Dirichlet flow's mesh pair, uh, sigma_proj
    and "SE" / "EV" fluxes; both equilibrators share one JAX engine."""
    cache = {}

    def get(mesh, k):
        if (mesh, k) in cache:
            return cache[mesh, k]
        jm, tm = _MESHES[mesh](jgen), _MESHES[mesh](tgen)
        V = jfem.FunctionSpace(jm, "P", k)
        rhs = jfem.local_projection(jfem.FunctionSpace(jm, "DG", k - 1), [_f],
                                    quadrature_degree=2 * k + 8)
        uh = JaxPoisson(V).solve(rhs[0], jm.boundary_facets, _u, rtol=1e-13)
        sp = jfem.local_projection(jfem.FunctionSpace(jm, "DG", k - 1, vs=2),
                                   [-1.0 * jfem.grad(uh)])
        engine = JaxEngine(jfem.FunctionSpace(jm, "RT", k), jax_patches(jm))
        out = dict(jm=jm, tm=tm, uh=uh, sp=sp[0])
        for name, Eqlb in (("SE", jeqlb.FluxEqlbSE), ("EV", jeqlb.FluxEqlbEV)):
            eq = Eqlb(k, jm, rhs, sp)
            eq.engine = engine
            eq.set_boundary_conditions([jm.boundary_facets], [[]])
            eq.equilibrate_fluxes()
            out[name] = eq.list_flux[0]
        cache[mesh, k] = out
        return out

    return get


def _port_function(tm, jfun):
    """The port's Function on the same space as a JAX Function, same dofs."""
    s = jfun.space
    V = tfem.FunctionSpace(tm, s.family, s.degree, vs=s.block_size
                           if s.family in ("P", "DG") else 1)
    return tfem.Function(V, np.asarray(jfun.x), device="cpu")


def _both(fl, name, coefficient=None):
    """estimate_poisson in both packages on the JAX flow's data."""
    sp_j = fl["sp"] if name == "SE" else None
    want = jax_estimate(_f, fl["uh"], fl[name], sp_j, coefficient=coefficient)
    tm = fl["tm"]
    sp_t = _port_function(tm, fl["sp"]) if name == "SE" else None
    got = estimate_poisson(_f, _port_function(tm, fl["uh"]),
                           _port_function(tm, fl[name]), sp_t,
                           coefficient=coefficient)
    return got, want


def _assert_estimates_close(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert isinstance(g, float)
        assert abs(g - float(w)) <= 1e-12 * abs(float(w))
    cell, ref = got[3], np.asarray(want[3])
    assert isinstance(cell, torch.Tensor) and cell.dtype == torch.float64
    assert cell.device.type == "cpu" and cell.shape == ref.shape
    assert np.abs(cell.numpy() - ref).max() <= 1e-12 * ref.max()


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", ["SE", "EV"])
def test_estimate_poisson_matches_jax(flows, mesh, k, name):
    got, want = _both(flows(mesh, k), name)
    _assert_estimates_close(got, want)
    assert got[0] > 0.0


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("name", ["SE", "EV"])
def test_estimate_poisson_coefficient_matches_jax(flows, mesh, name):
    """The ``coefficient`` branch (EV rescales grad(uh) through
    ``cell_scale``; both divide by kappa), a seeded checkerboard-like
    kappa given as a NumPy array."""
    fl = flows(mesh, 2)
    rng = np.random.default_rng(11)
    kap = np.where(rng.random(fl["tm"].num_cells) < 0.5, 161.4476387975881,
                   1.0)
    got, want = _both(fl, name, coefficient=kap)
    _assert_estimates_close(got, want)
    # a tensor coefficient gives the same numbers
    got_t, _ = _both(fl, name, coefficient=torch.as_tensor(kap))
    assert got_t[:3] == got[:3]
