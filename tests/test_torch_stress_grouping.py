"""Patch grouping and the KKT mode of the port's weakly symmetric stress
equilibration against the JAX package's, f64 on the CPU:

* patch grouping at degree 2 (deficient pure-traction corner patches,
  ``eqlb.grouping``) on the meshes of ``tests/test_grouping.py``: the
  groups identical, both rows after ``grouped_weak_symmetry`` within
  1e-11 * max(1, max|x|), and the specs of ``tests/test_grouping.py``
  (divergence, jump, boundary conditions, weak symmetry) on the port;
* the KKT mode with weak symmetry (``mode="kkt"``) within 1e-11 of JAX's
  on the crossed and permuted meshes at degree 2."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import eqlb as jeqlb
from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.eqlb import grouping as jgrouping
from dolfinx_eqlb_tpu.mesh import generators as jgen

from dolfinx_eqlb_tpu_torch import eqlb as teqlb
from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.eqlb import grouping as tgrouping
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen

# the KKT-size solves of the port on the CPU stay single-threaded (MKL's
# batched solve stalls with several threads at D >= ~160)
torch.set_num_threads(1)

_PKG = {"jax": (jfem, jeqlb), "torch": (tfem, teqlb)}


def _close(a_port, a_jax, rel):
    a_port = a_port.cpu().numpy() if isinstance(a_port, torch.Tensor) \
        else np.asarray(a_port)
    a_jax = np.asarray(a_jax)
    assert a_port.shape == a_jax.shape
    assert np.isfinite(a_port).all()
    tol = rel * max(1.0, float(np.abs(a_jax).max()))
    assert np.abs(a_port - a_jax).max() <= tol


def _poly(deg):
    """tests/test_stress.py's exact symmetric polynomial stress rows and
    their divergences."""
    d = deg
    rows = (lambda x: np.stack([x[..., 0] ** d + 2 * x[..., 1],
                                x[..., 0] * x[..., 1]], -1),
            lambda x: np.stack([x[..., 0] * x[..., 1],
                                x[..., 1] ** d - x[..., 0]], -1))
    fs = (lambda x: d * x[..., 0] ** (d - 1) + x[..., 0],
          lambda x: x[..., 1] + d * x[..., 1] ** (d - 1))
    return rows, fs, 8


# tests/test_grouping.py: sigma = [[x, y], [y, 2 - x]]
_LINEAR = ((lambda x: np.stack([x[..., 0], x[..., 1]], -1),
            lambda x: np.stack([x[..., 1], 2.0 - x[..., 0]], -1)),
           (lambda x: 2.0 * np.ones(x.shape[:-1]),
            lambda x: np.zeros(x.shape[:-1])), 6)


def _flow(pkg, msh, deg, data, traction=False, mode="semiexplicit"):
    """Project ``data`` (rows, divergences, quadrature degree) and run
    FluxEqlbSE with stress and Korn constants.  ``traction``: the grouping
    tests' BCs (traction on x = 0 and y = 0, primal-Dirichlet on the
    rest); else primal-Dirichlet everywhere."""
    fem, eqlb = _PKG[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    rows, fs, qdeg = data
    rhs = fem.local_projection(fem.FunctionSpace(msh, "DG", deg - 1),
                               list(fs), quadrature_degree=qdeg, **kw)
    proj = fem.local_projection(
        fem.FunctionSpace(msh, "DG", deg - 1, vs=2),
        [fem.expr_from_callable(r, msh, value_size=2) for r in rows],
        quadrature_degree=qdeg, **kw)
    eq = eqlb.FluxEqlbSE(deg, msh, rhs, proj, equilibrate_stress=True,
                         estimate_korn_constant=True)
    eq.engine.mode = mode
    if traction:
        side = [msh.locate_boundary_facets(
            lambda x, a=a, v=v: np.isclose(x[..., a], v))
            for a, v in ((0, 0.0), (1, 0.0), (0, 1.0), (1, 1.0))]
        left, bot, right, top = side
        prime = np.concatenate([right, top])
        bcs = [[eqlb.fluxbc(lambda x, r=r: -rows[r](x)[..., 0], left, None),
                eqlb.fluxbc(lambda x, r=r: -rows[r](x)[..., 1], bot, None)]
               for r in range(2)]
        eq.set_boundary_conditions([prime, prime], bcs)
        traction_facets = np.concatenate([left, bot])
    else:
        eq.set_boundary_conditions([msh.boundary_facets] * 2, [[], []])
        traction_facets = None
    eq.equilibrate_fluxes()
    return {"eq": eq, "rhs": rhs, "proj": proj, "traction": traction_facets}


_GROUP_MESHES = {
    "crossed": lambda g: g.unit_square(3),
    "permuted": lambda g: g.permute_vertices(g.unit_square(3), seed=5),
    "unstructured": lambda g: g.unit_square_unstructured(4, seed=2),
}


@pytest.mark.parametrize("mesh", sorted(_GROUP_MESHES))
def test_grouped_weak_symmetry_matches_jax(mesh):
    out = {pkg: _flow(pkg, _GROUP_MESHES[mesh](g), 2, _LINEAR, traction=True)
           for pkg, g in (("jax", jgen), ("torch", tgen))}
    fk2 = np.asarray(out["jax"]["eq"].boundary_data.facet_kind[:2])
    groups, skip = tgrouping.build_groups(out["torch"]["eq"].engine, fk2)
    want = jgrouping.build_groups(out["jax"]["eq"].engine, fk2)
    assert groups == want[0] and len(groups) >= 1
    np.testing.assert_array_equal(skip, want[1])
    for i in range(2):
        _close(out["torch"]["eq"].list_flux[i].x,
               out["jax"]["eq"].list_flux[i].x, 1e-11)
    # tests/test_grouping.py's spec on the port
    t = out["torch"]
    eq, proj, rhs = t["eq"], t["proj"], t["rhs"]
    for i in range(2):
        assert teqlb.check_divergence_condition(eq.list_flux[i], proj[i],
                                                rhs[i])
        assert teqlb.check_jump_condition(eq.list_flux[i], proj[i])
        if mesh != "unstructured":
            assert teqlb.check_boundary_conditions(
                eq.list_flux[i], proj[i], eq.list_bfunctions[i],
                np.asarray(t["traction"], dtype=np.int64))
    assert teqlb.check_weak_symmetry_condition(eq.list_flux, proj)


@pytest.mark.parametrize("mesh", ["crossed", "permuted"])
def test_kkt_weak_symmetry_matches_jax(mesh):
    out = {pkg: _flow(pkg, _GROUP_MESHES[mesh](g), 2, _poly(2), mode="kkt")
           for pkg, g in (("jax", jgen), ("torch", tgen))}
    for i in range(2):
        _close(out["torch"]["eq"].list_flux[i].x,
               out["jax"]["eq"].list_flux[i].x, 1e-11)
    t = out["torch"]
    assert teqlb.check_weak_symmetry_condition(t["eq"].list_flux, t["proj"])
