"""The port's geometric multigrid (``fem/multigrid.py``) and the multigrid
branches of its elasticity solvers against the JAX package, f64 on the
CPU:

* the host tables (``prolongation_tensor`` k = 1-3, both element-tensor
  functions, ``_boundary_scalar_dofs``) identical to JAX's;
* every level's ``Dinv``, ``free``, ``owner``, ``Ainv`` and ``lmax``
  within 1e-12 (relative to max(1, max|.|)) of JAX's, the index tables
  identical, block sizes 1 and 2;
* ``apply``, ``_prolong`` and ``_restrict`` within 1e-12 of JAX's on the
  same seeded vectors;
* ``minres`` with ``chunk`` 37 bitwise equal to ``chunk=None``;
* ``ElasticitySolver`` (CG) and ``ElasticitySolverUP`` (MINRES) with
  ``mg_meshes`` against JAX within 1e-10, iteration counts within one;
* the specs of ``tests/test_multigrid.py`` on the port alone."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.fem import multigrid as jmg
from dolfinx_eqlb_tpu.mesh import generators as jgen
from dolfinx_eqlb_tpu.models import elasticity as jel

from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.fem import multigrid as tmg
from dolfinx_eqlb_tpu_torch.fem.interpolate import interpolate
from dolfinx_eqlb_tpu_torch.fem.krylov import minres
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen
from dolfinx_eqlb_tpu_torch.models import elasticity as tel
from dolfinx_eqlb_tpu_torch.models.biot import BiotMG, BiotSolverUPP

torch.set_num_threads(2)

_PKG = {"jax": (jfem, jmg, jgen, jel), "torch": (tfem, tmg, tgen, tel)}


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * max(1.0, np.abs(want).max())


def _kw(pkg):
    return {"device": "cpu"} if pkg == "torch" else {}


def _sin_u(x):
    return np.stack([np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
                     -np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])],
                    -1)


def _level_fn(mg, bs, k):
    if bs == 1:
        return lambda m: mg.scalar_stiffness_tensors(m, k)
    return lambda m: mg.vector_eps_tensors(m, k)


# --- host tables ---------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 3])
def test_prolongation_tensor_identical(degree):
    assert np.array_equal(tmg.prolongation_tensor(degree),
                          jmg.prolongation_tensor(degree))


@pytest.mark.parametrize("fn,kw", [
    ("scalar_stiffness_tensors", {}),
    ("scalar_stiffness_tensors", {"mass_coeff": 1.0}),
    ("vector_eps_tensors", {}),
    ("vector_eps_tensors", {"div_coeff": 1.0}),
])
def test_element_tensors_identical(fn, kw):
    """On the unstructured mesh (cells of every shape), degrees 1-3."""
    for k in (1, 2, 3):
        got = getattr(tmg, fn)(tgen.unit_square_unstructured(5, seed=3), k,
                               **kw)
        want = getattr(jmg, fn)(jgen.unit_square_unstructured(5, seed=3), k,
                                **kw)
        assert np.array_equal(got, want), (fn, k)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_boundary_scalar_dofs_identical(degree):
    tm, jm = tgen.unit_square(3), jgen.unit_square(3)
    got = tmg._boundary_scalar_dofs(tm, tfem.FunctionSpace(tm, "P", degree))
    want = jmg._boundary_scalar_dofs(jm, jfem.FunctionSpace(jm, "P", degree))
    assert np.array_equal(got, want)


# --- GeometricMG against JAX ---------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 2], ids=["bs1", "bs2"])
def mg_pair(request):
    """Both packages' V-cycles on mesh_hierarchy(unit_square(3), 3), P2."""
    bs, k = request.param, 2
    out = {}
    for pkg in ("jax", "torch"):
        fem, mg, g, _ = _PKG[pkg]
        meshes = mg.mesh_hierarchy(g.unit_square(3), 3)
        out[pkg] = mg.GeometricMG(meshes, k, _level_fn(mg, bs, k),
                                  block_size=bs, **_kw(pkg))
    return out


def test_level_tables_match_jax(mg_pair):
    J, T = mg_pair["jax"], mg_pair["torch"]
    assert T.nlevels == J.nlevels == 3
    assert T._nds == J._nds
    for l, (a, b) in enumerate(zip(J.operands(), T.operands())):
        for key in ("cd", "cds_scalar", "cds_f", "cds_c"):
            if key in a:
                assert np.array_equal(_np(b[key]), np.asarray(a[key])), \
                    (l, key)
        for key in ("Dinv", "free", "owner", "Ainv", "Ae", "Ptab"):
            if key in a:
                _close(b[key], a[key], 1e-12)
        assert abs(b["lmax"] - float(a["lmax"])) <= 1e-12 * float(a["lmax"])


def test_vcycle_and_transfers_match_jax(mg_pair):
    import jax.numpy as jnp

    J, T = mg_pair["jax"], mg_pair["torch"]
    jops, tops = J.operands(), T.operands()
    rng = np.random.default_rng(0)
    r = rng.standard_normal(tops[-1]["Dinv"].shape[0])
    _close(T.apply(torch.as_tensor(r)), J.apply(jnp.asarray(r), jops), 1e-12)
    _close(T.apply(torch.as_tensor(r), tops),
           J.apply(jnp.asarray(r), jops), 1e-12)
    for l in (1, 2):
        rc = rng.standard_normal(tops[l - 1]["Dinv"].shape[0])
        _close(T._prolong(tops[l], torch.as_tensor(rc)),
               J._prolong(jops[l], jnp.asarray(rc)), 1e-12)
        rf = rng.standard_normal(tops[l]["Dinv"].shape[0])
        _close(T._restrict(tops[l], torch.as_tensor(rf), T._nds[l - 1]),
               J._restrict(jops[l], jnp.asarray(rf), J._nds[l - 1]), 1e-12)


def test_hierarchy_must_be_nested():
    meshes = [tgen.unit_square(2), tgen.unit_square(3)]
    with pytest.raises(ValueError, match="red refinements"):
        tmg.GeometricMG(meshes, 1, lambda m: tmg.scalar_stiffness_tensors(
            m, 1), device="cpu")


# --- minres with chunk -----------------------------------------------------------------

@pytest.mark.parametrize("chunk", [37, 4000])
def test_minres_chunk_bitwise(chunk):
    """``chunk`` is accepted and changes nothing: bitwise equal to None,
    with a V-cycle preconditioner on the P2 Poisson system."""
    meshes = tmg.mesh_hierarchy(tgen.unit_square(3), 2)
    mg = tmg.GeometricMG(meshes, 2, lambda m: tmg.scalar_stiffness_tensors(
        m, 2), device="cpu")
    o = mg.operands()[-1]
    n = o["Dinv"].shape[0]
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(n)) \
        * o["free"]

    def run(ch):
        return minres(lambda v: mg._matvec(o, v), b,
                      torch.zeros(n, dtype=torch.float64), mg.apply,
                      o["free"] > 0, rtol=1e-10, maxiter=500, chunk=ch)

    ref, st = run(None), run(chunk)
    assert st["it"] == ref["it"] > 0
    assert torch.equal(st["x"], ref["x"])
    assert torch.equal(st["phibar"], ref["phibar"])


# --- the elasticity solvers' multigrid branches against JAX -----------------------------

@pytest.fixture(scope="module")
def ela_mg():
    """Both packages' MG solves on mesh_hierarchy(unit_square(3), 3): the
    displacement CG (P2) and the Herrmann MINRES (P2 x P1)."""
    out = {}
    for pkg in ("jax", "torch"):
        fem, mg, g, el = _PKG[pkg]
        meshes = mg.mesh_hierarchy(g.unit_square(3), 3)
        msh = meshes[-1]
        f = fem.expr_from_callable(lambda x: 2 * np.pi**2 * _sin_u(x), msh,
                                   value_size=2)
        ud = fem.expr_from_callable(_sin_u, msh, value_size=2)
        s = el.ElasticitySolver(fem.FunctionSpace(msh, "P", 2, vs=2), 1.0,
                                **_kw(pkg))
        u = s.solve(f, msh.boundary_facets, ud, rtol=1e-12, mg_meshes=meshes)
        sup = el.ElasticitySolverUP(fem.FunctionSpace(msh, "P", 2, vs=2),
                                    fem.FunctionSpace(msh, "P", 1), 1.0,
                                    **_kw(pkg))
        uu, pp = sup.solve(f, msh.boundary_facets, ud, rtol=1e-12,
                           mg_meshes=meshes)
        out[pkg] = dict(meshes=meshes, solver=s, u=(u.x, s.last_iterations),
                        up=(np.concatenate([_np(uu.x), _np(pp.x)]),
                            sup.last_iterations), f=f, ud=ud)
    return out


@pytest.mark.parametrize("form", ["u", "up"])
def test_elasticity_mg_matches_jax(ela_mg, form):
    got, want = ela_mg["torch"][form], ela_mg["jax"][form]
    _close(got[0], want[0], 1e-10)
    assert abs(got[1] - want[1]) <= 1, (got[1], want[1])


def test_elasticity_prebuilt_mg(ela_mg):
    """A prebuilt GeometricMG of the same operator gives the same solve."""
    r = ela_mg["torch"]
    meshes, s = r["meshes"], r["solver"]
    mg = tmg.GeometricMG(
        meshes, 2, lambda m: tmg.vector_eps_tensors(m, 2, div_coeff=1.0),
        block_size=2, device="cpu")
    u = s.solve(r["f"], meshes[-1].boundary_facets, r["ud"], rtol=1e-12,
                mg_meshes=mg)
    assert torch.equal(u.x, r["u"][0])
    assert s.last_iterations == r["u"][1] and s.last_maxiter == 200


@pytest.mark.parametrize("form", ["u", "up"])
@pytest.mark.parametrize("fault", ["partial_boundary", "copied_mesh"])
def test_elasticity_mg_preconditions(ela_mg, form, fault):
    """The MG branches raise unless u is essential on the whole boundary
    and the hierarchy's finest mesh is the solver's mesh object."""
    r = ela_mg["torch"]
    meshes = list(r["meshes"])
    msh = meshes[-1]
    facets = msh.boundary_facets
    if fault == "partial_boundary":
        facets = facets[: len(facets) // 2]
    else:
        meshes[-1] = tmg.mesh_hierarchy(tgen.unit_square(3), 3)[-1]
    if form == "u":
        s = r["solver"]
    else:
        s = tel.ElasticitySolverUP(tfem.FunctionSpace(msh, "P", 2, vs=2),
                                   tfem.FunctionSpace(msh, "P", 1), 1.0,
                                   device="cpu")
    with pytest.raises(ValueError, match="whole boundary|solver's mesh"):
        s.solve(r["f"], facets, r["ud"], rtol=1e-12, mg_meshes=meshes)


# --- the specs of tests/test_multigrid.py on the port ---------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 3])
def test_prolongation_exact_on_pk(degree):
    """Prolongation of the coarse interpolant of a degree-k polynomial
    equals the fine interpolant."""
    meshes = tmg.mesh_hierarchy(tgen.unit_square(3), 2)
    k = degree

    def poly(x):
        return (x[..., 0] ** k + 0.5 * x[..., 1] ** k
                + (x[..., 0] * x[..., 1]) ** (k // 2) - 0.25)

    mg = tmg.GeometricMG(meshes, k, lambda m: tmg.scalar_stiffness_tensors(
        m, k, 1.0), bc_dofs_fn=None, device="cpu")
    vals = [interpolate(tfem.FunctionSpace(m, "P", k), poly,
                        device="cpu").x for m in meshes]
    fine = mg._prolong(mg.operands()[1], vals[0])
    assert float((fine - vals[1]).abs().max()) < 1e-12


@pytest.mark.parametrize("block_size", [1, 2])
def test_vcycle_symmetric(block_size):
    """<B r1, r2> == <r1, B r2>."""
    meshes = tmg.mesh_hierarchy(tgen.unit_square(3), 3)
    mg = tmg.GeometricMG(meshes, 2, _level_fn(tmg, block_size, 2),
                         block_size=block_size, device="cpu")
    o = mg.operands()[-1]
    n = o["Dinv"].shape[0]
    rng = np.random.default_rng(0)
    r1 = torch.as_tensor(rng.standard_normal(n)) * o["free"]
    r2 = torch.as_tensor(rng.standard_normal(n)) * o["free"]
    z1, z2 = mg.apply(r1), mg.apply(r2)
    dev = abs(float(torch.dot(z1, r2) - torch.dot(r1, z2)))
    assert dev < 1e-12 * float(z1.norm() * r2.norm())


def _poisson_its(nlevels, k, psolve_kind):
    meshes = tmg.mesh_hierarchy(tgen.unit_square(4), nlevels)
    mg = tmg.GeometricMG(meshes, k, lambda m: tmg.scalar_stiffness_tensors(
        m, k), device="cpu")
    o = mg.operands()[-1]
    n = o["Dinv"].shape[0]
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(n)) \
        * o["free"]
    Minv = mg.apply if psolve_kind == "mg" else o["Dinv"]
    st = minres(lambda v: mg._matvec(o, v), b,
                torch.zeros(n, dtype=torch.float64), Minv, o["free"] > 0,
                rtol=1e-10, maxiter=2000)
    assert float(st["phibar"]) < 1e-9 * float(b.norm())
    return st["it"]


def test_poisson_mesh_independent_iterations():
    its2 = _poisson_its(2, 2, "mg")
    its3 = _poisson_its(3, 2, "mg")
    its_jacobi = _poisson_its(2, 2, "jacobi")
    assert its3 <= 25 and its2 <= 25
    assert its3 <= its2 + 5
    assert its_jacobi > 3 * its3


def test_biot_mg_matches_jacobi_and_is_mesh_independent():
    from tests.test_biot import f_body, g_flow

    k = 2
    its, sols = {}, {}
    for nlevels in (2, 3):
        meshes = tmg.mesh_hierarchy(tgen.unit_square(3), nlevels)
        msh = meshes[-1]
        fe = tfem.local_projection(
            tfem.FunctionSpace(msh, "DG", k - 1, vs=2),
            [tfem.expr_from_callable(f_body, msh, value_size=2)],
            quadrature_degree=2 * k + 6, device="cpu")[0]
        ge = tfem.local_projection(
            tfem.FunctionSpace(msh, "DG", k - 1),
            [tfem.expr_from_callable(g_flow, msh, value_size=1)],
            quadrature_degree=2 * k + 6, device="cpu")[0]
        solver = BiotSolverUPP(tfem.FunctionSpace(msh, "P", k, vs=2),
                               tfem.FunctionSpace(msh, "P", k),
                               tfem.FunctionSpace(msh, "P", k - 1),
                               device="cpu")
        sol = solver.solve(fe, ge, msh.boundary_facets, rtol=1e-12,
                           mg=BiotMG(solver, meshes))
        its[nlevels] = solver.last_iterations
        sols[nlevels] = (solver, fe, ge) + sol
    assert its[2] <= 80 and its[3] <= 80, its
    assert its[3] <= its[2] + 10, its

    solver, fe, ge, uh, ph, pth = sols[3]
    uj, pj, ptj = solver.solve(fe, ge, solver.Vu.mesh.boundary_facets,
                               rtol=1e-12)
    assert solver.last_iterations > 3 * its[3]
    scale = float(uj.x.abs().max()) + 1.0
    for a, b in ((uh, uj), (ph, pj), (pth, ptj)):
        assert float((a.x - b.x).abs().max()) < 1e-8 * scale


def test_elasticity_displacement_mg_matches_jacobi():
    meshes = tmg.mesh_hierarchy(tgen.unit_square(3), 3)
    msh = meshes[-1]
    f = tfem.expr_from_callable(lambda x: 2 * np.pi**2 * _sin_u(x), msh,
                                value_size=2)
    ud = tfem.expr_from_callable(_sin_u, msh, value_size=2)
    s = tel.ElasticitySolver(tfem.FunctionSpace(msh, "P", 2, vs=2), 1.0,
                             device="cpu")
    u_mg = s.solve(f, msh.boundary_facets, ud, rtol=1e-12, mg_meshes=meshes)
    its_mg = s.last_iterations
    u_j = s.solve(f, msh.boundary_facets, ud, rtol=1e-12)
    assert its_mg <= 30
    assert s.last_iterations > 3 * its_mg
    scale = float(u_j.x.abs().max()) + 1.0
    assert float((u_mg.x - u_j.x).abs().max()) < 1e-8 * scale


def test_herrmann_mg_matches_jacobi():
    meshes = tmg.mesh_hierarchy(tgen.unit_square(3), 3)
    msh = meshes[-1]
    f = tfem.expr_from_callable(lambda x: 2 * np.pi**2 * _sin_u(x), msh,
                                value_size=2)
    ud = tfem.expr_from_callable(_sin_u, msh, value_size=2)
    spaces = (tfem.FunctionSpace(msh, "P", 2, vs=2),
              tfem.FunctionSpace(msh, "P", 1))
    s_mg = tel.ElasticitySolverUP(*spaces, pi_1=1.0, device="cpu")
    u_mg, p_mg = s_mg.solve(f, msh.boundary_facets, ud, rtol=1e-12,
                            mg_meshes=meshes)
    s_j = tel.ElasticitySolverUP(*spaces, pi_1=1.0, device="cpu")
    u_j, p_j = s_j.solve(f, msh.boundary_facets, ud, rtol=1e-12)
    assert s_mg.last_iterations <= 120
    assert s_j.last_iterations > 2 * s_mg.last_iterations
    scale = float(u_j.x.abs().max()) + 1.0
    assert float((u_mg.x - u_j.x).abs().max()) < 1e-8 * scale
    assert float((p_mg.x - p_j.x).abs().max()) < 1e-7 * scale
