"""The port's weakly symmetric stress equilibration against the JAX
package's, on the crossed ``unit_square(3)``, f64 on the CPU:

* ``FluxEqlbSE(equilibrate_stress=True, estimate_korn_constant=True)`` on
  the exact polynomial stress of ``tests/test_stress.py`` at k = 2-4: both
  stress rows within 1e-11 * max(1, max|x|), the Korn constants within
  1e-12;
* the 12 componentwise BC layouts of ``tests/test_stress_bc_layouts.py``
  x k = 2-4, but for the three whose corner system has no unique solution
  at k = 2: both rows within 1e-11 * max(1, max|x|), and the per-patch
  mask of the rank-1 regularisation of the masked stress systems
  (``stress.weak_symmetry_bucket_bl``) identical to the one the rule gives
  on the JAX engine's stress systems;
* the stress caches (``build_stress_cache``) within 1e-12 * max(1, max|t|);
* the host pieces (``deficient_stress_vertices``, ``refine_for_stress``,
  ``cook_membrane``, ``build_groups``) identical;

and the specs of ``tests/test_stress.py`` and
``tests/test_stress_bc_layouts.py`` run on the port alone (all three
meshes of the former).  One JAX engine per degree serves every case (its
compiled program takes the facet kinds and BC values as arguments)."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import eqlb as jeqlb
from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.equilibrators import _mesh_patches as jax_patches
from dolfinx_eqlb_tpu.eqlb import grouping as jgrouping
from dolfinx_eqlb_tpu.eqlb import patches as jpatches
from dolfinx_eqlb_tpu.mesh import generators as jgen

from dolfinx_eqlb_tpu_torch import eqlb as teqlb
from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.eqlb import grouping as tgrouping
from dolfinx_eqlb_tpu_torch.eqlb import patches as tpatches
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen

# the KKT-size solves of the port on the CPU stay single-threaded (MKL's
# batched solve stalls with several threads at D >= ~160)
torch.set_num_threads(1)

_PKG = {"jax": (jfem, jeqlb, jgen), "torch": (tfem, teqlb, tgen)}


def _sigma_rows(deg):
    """tests/test_stress.py's exact symmetric polynomial stress
    sigma = [[a, c], [c, b]], a = x^d + 2y, b = y^d - x, c = x y, and its
    divergence rows."""
    d = deg

    def row0(x):
        return np.stack([x[..., 0] ** d + 2 * x[..., 1],
                         x[..., 0] * x[..., 1]], -1)

    def row1(x):
        return np.stack([x[..., 0] * x[..., 1],
                         x[..., 1] ** d - x[..., 0]], -1)

    def f0(x):
        return d * x[..., 0] ** (d - 1) + x[..., 0]

    def f1(x):
        return x[..., 1] + d * x[..., 1] ** (d - 1)

    return (row0, row1), (f0, f1)


# tests/test_stress_bc_layouts.py: sigma = [[x, y], [y, 2 - x]]
ROWS = (
    lambda x: np.stack([x[..., 0], x[..., 1]], -1),
    lambda x: np.stack([x[..., 1], 2.0 - x[..., 0]], -1),
)
FS = (lambda x: 2.0 * np.ones(x.shape[:-1]), lambda x: np.zeros(x.shape[:-1]))
LAYOUTS = {
    1: [[True, False], [False, False]],
    2: [[False, True], [False, False]],
    3: [[False, False], [False, True]],
    4: [[False, False], [True, False]],
    5: [[True, False], [False, True]],
    6: [[True, False], [True, False]],
    7: [[False, True], [False, True]],
    8: [[False, True], [True, False]],
    9: [[True, False], [True, True]],
    10: [[False, True], [True, True]],
    11: [[True, True], [False, True]],
    12: [[True, True], [True, False]],
}
# component-crossed corners at degree 2, where the JAX spec (and the
# reference) expect the conditions to fail: held to JAX only
CROSSED_DEG2 = {8, 10, 12}


def _close(a_port, a_jax, rel):
    a_port = a_port.cpu().numpy() if isinstance(a_port, torch.Tensor) \
        else np.asarray(a_port)
    a_jax = np.asarray(a_jax)
    assert a_port.shape == a_jax.shape
    assert np.isfinite(a_port).all()
    tol = rel * max(1.0, float(np.abs(a_jax).max()))
    assert np.abs(a_port - a_jax).max() <= tol


def _poly_problem(pkg, msh, deg):
    fem, eqlb, _ = _PKG[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    (row0, row1), (f0, f1) = _sigma_rows(deg)
    rhs = fem.local_projection(fem.FunctionSpace(msh, "DG", deg - 1),
                               [f0, f1], quadrature_degree=8, **kw)
    proj = fem.local_projection(
        fem.FunctionSpace(msh, "DG", deg - 1, vs=2),
        [fem.expr_from_callable(row0, msh, value_size=2),
         fem.expr_from_callable(row1, msh, value_size=2)],
        quadrature_degree=8, **kw)
    return rhs, proj, [msh.boundary_facets] * 2, [[], []]


def _layout_problem(pkg, msh, deg, id_bc):
    fem, eqlb, _ = _PKG[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    flags = LAYOUTS[id_bc]
    side = {name: msh.locate_boundary_facets(
        lambda x, a=a, v=v: np.isclose(x[..., a], v))
        for name, a, v in (("left", 0, 0.0), ("bottom", 1, 0.0),
                           ("right", 0, 1.0), ("top", 1, 1.0))}
    normal = {"left": np.array([-1.0, 0.0]), "bottom": np.array([0.0, -1.0])}
    rhs = fem.local_projection(fem.FunctionSpace(msh, "DG", deg - 1),
                               list(FS), quadrature_degree=6, **kw)
    proj = fem.local_projection(
        fem.FunctionSpace(msh, "DG", deg - 1, vs=2),
        [fem.expr_from_callable(r, msh, value_size=2) for r in ROWS],
        quadrature_degree=6, **kw)
    prime, bcs = [], []
    for row in range(2):
        p, b = [side["right"], side["top"]], []
        for si, name in enumerate(("left", "bottom")):
            if flags[si][row]:
                b.append(eqlb.fluxbc(
                    lambda x, r=row, n=normal[name]: ROWS[r](x) @ n,
                    side[name], None))
            else:
                p.append(side[name])
        prime.append(np.concatenate(p))
        bcs.append(b)
    return rhs, proj, prime, bcs


def _equilibrate(pkg, msh, deg, problem, engine=None):
    _, eqlb, _ = _PKG[pkg]
    rhs, proj, prime, bcs = problem
    eq = eqlb.FluxEqlbSE(deg, msh, rhs, proj, equilibrate_stress=True,
                         estimate_korn_constant=True)
    if engine is not None:
        eq.engine = engine
    eq.set_boundary_conditions(prime, bcs)
    eq.equilibrate_fluxes()
    return {"eq": eq, "rhs": rhs, "proj": proj}


@pytest.fixture(scope="module")
def crossed():
    """crossed(deg, case) -> {"jax": ..., "torch": ...}; case "poly" (the
    exact polynomial stress, all-Dirichlet) or a BC layout id."""
    meshes = {pkg: g.unit_square(3) for pkg, (_, _, g) in _PKG.items()}
    engines, cache = {}, {}

    def get(deg, case):
        if (deg, case) not in cache:
            out = {}
            for pkg, msh in meshes.items():
                problem = (_poly_problem(pkg, msh, deg) if case == "poly"
                           else _layout_problem(pkg, msh, deg, case))
                engine = None
                if pkg == "jax":
                    if deg not in engines:
                        engines[deg] = JaxEngine(
                            jfem.FunctionSpace(msh, "RT", deg),
                            jax_patches(msh))
                    engine = engines[deg]
                out[pkg] = _equilibrate(pkg, msh, deg, problem, engine)
                out[pkg]["mesh"] = msh
            cache[deg, case] = out
        return cache[deg, case]

    return get


def _rows_close(out, rel=1e-11):
    for i in range(2):
        _close(out["torch"]["eq"].list_flux[i].x,
               out["jax"]["eq"].list_flux[i].x, rel)


@pytest.mark.parametrize("deg", [2, 3, 4])
def test_stress_matches_jax(crossed, deg):
    out = crossed(deg, "poly")
    _rows_close(out)
    _close(out["torch"]["eq"].get_korn_constants().x,
           out["jax"]["eq"].get_korn_constants().x, 1e-12)


def _jax_sing(engine, key, fk2):
    """The rank-1 regularisation's per-patch mask, restated in NumPy on the
    JAX engine's masked stress system of boundary bucket ``key``: the
    constant constraint mode v = 1/sqrt(C) on the free multiplier rows is
    singular when ||Sr v|| < 1e-6 (mean |diag Sr| + 1e-30)."""
    st, t = engine.se_static[key], engine.tables[key]
    k = engine.k
    Dz, C, ns = st["Dz"], t["np1"], engine.buckets[key].nspokes
    D = 2 * Dz + C + 1
    dv = engine._dev[key]
    S = np.asarray(dv["S_stress"])  # (D, D, P)
    ess = fk2[:, np.asarray(dv["bspokes"])] == 2  # (2, P, 2)
    P = S.shape[-1]
    free = np.ones((D, P), dtype=bool)
    for row in range(2):
        fr = free[row * Dz:(row + 1) * Dz]
        fr[0] = ~(ess[row, :, 0] | ess[row, :, 1])
        if k > 1:
            fr[1:k] = ~ess[row, :, 0]
            r1 = 1 + (ns - 1) * (k - 1)
            fr[r1:r1 + k - 1] = ~ess[row, :, 1]
    free[2 * Dz + C] = ess.all(axis=(0, 2))
    ff = free[:, None] & free[None, :]
    Sr = np.where(ff, S, 0.0) + np.eye(D)[..., None] * (~free)[None]
    cr = slice(2 * Dz, 2 * Dz + C)
    v = np.where(free[cr], 1.0 / np.sqrt(C), 0.0)  # (C, P)
    Sv = np.einsum("djp,jp->dp", Sr[:, cr], v)
    diag_scale = np.abs(np.einsum("jjp->jp", Sr)).sum(0) / D
    return np.sqrt((Sv * Sv).sum(0)) < 1e-6 * (diag_scale + 1e-30)


# the component-crossed corners at degree 2 leave a corner system without
# a unique solution, so two pivoted LUs may pick different ones: those
# cases are held by their check verdicts only (test_stress_bc_layout_spec)
_WELL_POSED = [(deg, id_bc) for deg in (2, 3, 4) for id_bc in sorted(LAYOUTS)
               if not (deg == 2 and id_bc in CROSSED_DEG2)]


@pytest.mark.parametrize("deg, id_bc", _WELL_POSED)
def test_stress_bc_layout_matches_jax(crossed, deg, id_bc):
    out = crossed(deg, id_bc)
    _rows_close(out)
    teng, jeng = out["torch"]["eq"].engine, out["jax"]["eq"].engine
    fk2 = np.asarray(out["jax"]["eq"].boundary_data.facet_kind[:2])
    boundary = [key for key, b in teng.buckets.items() if b.is_boundary]
    assert sorted(teng.ws_sing) == sorted(boundary)
    for key in boundary:
        np.testing.assert_array_equal(teng.ws_sing[key].numpy(),
                                      _jax_sing(jeng, key, fk2))


@pytest.mark.parametrize("id_bc", sorted(LAYOUTS))
@pytest.mark.parametrize("deg", [2, 3, 4])
def test_stress_bc_layout_spec(crossed, id_bc, deg):
    """tests/test_stress_bc_layouts.py on the port: divergence, jump and
    weak symmetry hold, with the port's verdicts those of JAX.  At degree
    2 on the component-crossed corners the corner system has no unique
    solution, and weak symmetry cannot hold (the JAX spec, like the
    reference, expects it to fail): there both packages fail it, and the
    port keeps the divergence and jump conditions."""
    out = crossed(deg, id_bc)
    verdicts = {}
    for pkg in ("jax", "torch"):
        _, eqlb, _ = _PKG[pkg]
        r = out[pkg]
        flux, proj, rhs = r["eq"].list_flux, r["proj"], r["rhs"]
        verdicts[pkg] = [
            *(bool(eqlb.check_divergence_condition(flux[i], proj[i], rhs[i]))
              for i in range(2)),
            *(bool(eqlb.check_jump_condition(flux[i], proj[i]))
              for i in range(2)),
            bool(eqlb.check_weak_symmetry_condition(flux, proj))]
    if deg == 2 and id_bc in CROSSED_DEG2:
        assert verdicts["torch"] == [True] * 4 + [False]
        assert not verdicts["jax"][4]
    else:
        assert verdicts["torch"] == verdicts["jax"] == [True] * 5


@pytest.mark.parametrize("deg", [2, 3, 4])
def test_stress_caches_match_jax(crossed, deg):
    out = crossed(deg, "poly")
    teng, jeng = out["torch"]["eq"].engine, out["jax"]["eq"].engine
    tdev, _ = teng._device_tables()
    for key in sorted(teng.buckets):
        names = ["Bsym_bl", "S_stress" if teng.buckets[key].is_boundary
                 else "Sinv_c"]
        for name in names:
            _close(tdev[key][name], jeng._dev[key][name], 1e-12)


_STRESS_MESHES = {
    "crossed": lambda g: g.unit_square(3),
    "permuted": lambda g: g.permute_vertices(g.unit_square(3), seed=21),
    "unstructured": lambda g: g.unit_square_unstructured(4, seed=1),
}


@pytest.mark.parametrize("mesh", sorted(_STRESS_MESHES))
@pytest.mark.parametrize("deg", [2, 3, 4])
def test_stress_equilibration_conditions(mesh, deg):
    """tests/test_stress.py's spec on the port alone."""
    msh = _STRESS_MESHES[mesh](tgen)
    r = _equilibrate("torch", msh, deg, _poly_problem("torch", msh, deg))
    eq, proj, rhs = r["eq"], r["proj"], r["rhs"]
    for i in range(2):
        assert teqlb.check_divergence_condition(eq.list_flux[i], proj[i],
                                                rhs[i]), ("divergence", i)
        assert teqlb.check_jump_condition(eq.list_flux[i], proj[i])
    assert teqlb.check_weak_symmetry_condition(eq.list_flux, proj)
    vals = eq.get_korn_constants().evaluate(np.array([[1 / 3, 1 / 3]]))
    vals = vals[:, 0, 0].numpy()
    assert (vals > 1.0).all() and (vals < 1e3).all()


def test_stress_without_symmetry_violates():
    """Without the weak-symmetry step the condition fails, so the test
    above exercises the correction."""
    msh = tgen.unit_square(3)
    rhs, proj, prime, bcs = _poly_problem("torch", msh, 2)
    eq = teqlb.FluxEqlbSE(2, msh, rhs, proj, equilibrate_stress=False)
    eq.set_boundary_conditions(prime, bcs)
    eq.equilibrate_fluxes()
    assert not teqlb.check_weak_symmetry_condition(eq.list_flux, proj,
                                                   atol=1e-12)


# --- host pieces ------------------------------------------------------------------

def _traction_kinds(msh, sides):
    fk = np.zeros((2, msh.num_facets), dtype=np.int8)
    fk[:, msh.boundary_facets] = 1
    for a, v in sides:
        fk[:, msh.locate_boundary_facets(
            lambda x, a=a, v=v: np.isclose(x[..., a], v))] = 2
    return fk


_HOST_MESHES = {
    "crossed": lambda g: g.unit_square(3),
    "right": lambda g: g.unit_square(3, "right"),
    "permuted": lambda g: g.permute_vertices(g.unit_square(3), seed=5),
    "unstructured": lambda g: g.unit_square_unstructured(4, seed=2),
}
_SIDES = [((0, 0.0), (1, 0.0)), ((0, 0.0), (1, 0.0), (0, 1.0), (1, 1.0))]


@pytest.mark.parametrize("mesh", sorted(_HOST_MESHES))
@pytest.mark.parametrize("sides", [0, 1])
def test_deficient_and_refine_identical(mesh, sides):
    jm, tm = (_HOST_MESHES[mesh](g) for g in (jgen, tgen))
    fk = _traction_kinds(jm, _SIDES[sides])
    np.testing.assert_array_equal(
        tpatches.deficient_stress_vertices(tm, fk),
        jpatches.deficient_stress_vertices(jm, fk))
    traction = np.where(fk[0] == 2)[0]
    rj = jpatches.refine_for_stress(jm, traction)
    rt = tpatches.refine_for_stress(tm, traction)
    np.testing.assert_array_equal(rt.points, rj.points)
    np.testing.assert_array_equal(rt.cells, rj.cells)


@pytest.mark.parametrize("nx, ny", [(2, 2), (3, 5)])
def test_cook_membrane_identical(nx, ny):
    jm, tm = jgen.cook_membrane(nx, ny), tgen.cook_membrane(nx, ny)
    np.testing.assert_array_equal(tm.points, jm.points)
    np.testing.assert_array_equal(tm.cells, jm.cells)


@pytest.mark.parametrize("mesh", sorted(_HOST_MESHES))
@pytest.mark.parametrize("sides", [0, 1])
def test_build_groups_identical(mesh, sides):
    jm, tm = (_HOST_MESHES[mesh](g) for g in (jgen, tgen))
    fk = _traction_kinds(jm, _SIDES[sides])
    jeng = JaxEngine(jfem.FunctionSpace(jm, "RT", 2), jax_patches(jm))
    teng = teqlb.EqlbEngine(tfem.FunctionSpace(tm, "RT", 2),
                            teqlb.build_patches(tm), device="cpu")
    try:
        want = jgrouping.build_groups(jeng, fk)
    except ValueError as e:
        with pytest.raises(ValueError, match="Incompatible mesh"):
            tgrouping.build_groups(teng, fk)
        assert "Incompatible mesh" in str(e)
        return
    got = tgrouping.build_groups(teng, fk)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
