"""The port's flux user API against the JAX package's, end to end on the
CPU: ``PoissonSolver``, then ``local_projection`` of the RHS and of
-grad(uh), ``FluxEqlbSE`` / ``FluxEqlbEV`` with flux BCs, and the condition
checks — the flow of ``demos/demo_reconstruction.py``.

Both packages get the same inputs: the equilibrators and the checks are fed
the JAX primal solution's dofs (``Function(V, np.asarray(uh.x),
device="cpu")``), so each stage is held to the JAX result on its own;
``PoissonSolver`` is held to JAX's on the same projected data.  f64,
within 1e-11 * max(1, max|x|) unless stated.

JAX work is shared through module fixtures: one JAX engine per (mesh, k)
serves every BC case and both equilibrators (its compiled program takes
the facet kinds and BC values as arguments), and each (mesh, k, BC)
primal solve runs once."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import eqlb as jeqlb
from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.eqlb import checks as jchecks
from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.equilibrators import _mesh_patches as jax_patches
from dolfinx_eqlb_tpu.mesh import generators as jgen
from dolfinx_eqlb_tpu.models import PoissonSolver as JaxPoisson
from dolfinx_eqlb_tpu.models import locate_dofs_on_facets as jax_locate

from dolfinx_eqlb_tpu_torch import eqlb as teqlb
from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.elmtlib import create_hierarchic_rt
from dolfinx_eqlb_tpu_torch.eqlb import checks as tchecks
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen
from dolfinx_eqlb_tpu_torch.models import PoissonSolver, locate_dofs_on_facets

torch.set_num_threads(2)

_MESHES = {
    "crossed": lambda g: g.unit_square(3),
    "permuted": lambda g: g.permute_vertices(g.unit_square(3), seed=13),
}
_BCS = ["dirichlet", "neumann_hom", "neumann_inhom"]
_PKG = {"jax": (jfem, jeqlb), "torch": (tfem, teqlb)}


def _u(x):
    return np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def _f(x):
    return 8 * np.pi**2 * _u(x)


def _ux(x):
    return (2 * np.pi * np.cos(2 * np.pi * x[..., 0])
            * np.cos(2 * np.pi * x[..., 1]))


def _close(a_port, a_jax, rel=1e-11):
    a_port = a_port.numpy() if isinstance(a_port, torch.Tensor) else a_port
    a_jax = np.asarray(a_jax)
    assert a_port.shape == a_jax.shape
    assert np.isfinite(a_port).all()
    tol = rel * max(1.0, float(np.abs(a_jax).max()))
    assert np.abs(a_port - a_jax).max() <= tol


def _problem(pkg, msh, k, bc):
    """demo_reconstruction's data on one package: spaces, projected RHS,
    primal facets, primal Neumann data and flux BCs."""
    fem, eqlb = _PKG[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    side = {name: msh.locate_boundary_facets(
        lambda x, a=a, v=v: np.isclose(x[..., a], v))
        for name, a, v in (("left", 0, 0.0), ("right", 0, 1.0),
                           ("bot", 1, 0.0), ("top", 1, 1.0))}
    p = {"V": fem.FunctionSpace(msh, "P", k),
         "Vf": fem.FunctionSpace(msh, "DG", k - 1, vs=2), "neumann": None}
    p["rhs"] = fem.local_projection(fem.FunctionSpace(msh, "DG", k - 1),
                                    [_f], quadrature_degree=2 * k + 8, **kw)
    if bc == "dirichlet":
        p["prime"], p["bcs"] = msh.boundary_facets, []
    else:
        p["prime"] = np.concatenate([side["bot"], side["top"]])
    if bc == "neumann_hom":
        p["bcs"] = [eqlb.fluxbc(0.0, np.concatenate([side["left"],
                                                     side["right"]]))]
    elif bc == "neumann_inhom":
        gl = fem.project_facet_trace(msh, side["left"], lambda x: -_ux(x), k)
        gr = fem.project_facet_trace(msh, side["right"], _ux, k)
        p["neumann"] = [(side["left"], gl), (side["right"], gr)]
        p["bcs"] = [eqlb.fluxbc(-gl, side["left"]),
                    eqlb.fluxbc(-gr, side["right"])]
    return p


def _equilibrate(pkg, Eqlb, k, msh, p, sigma_proj, engine=None):
    eq = Eqlb(k, msh, p["rhs"], sigma_proj)
    if engine is not None:
        eq.engine = engine
    eq.set_boundary_conditions([p["prime"]], [p["bcs"]])
    eq.equilibrate_fluxes()
    return eq


@pytest.fixture(scope="module")
def flows():
    """flows(mesh, k, bc) -> {"jax": ..., "torch": ...}, each with the
    mesh, the problem, uh, sigma_proj and the "SE" / "EV" equilibrators."""
    meshes, engines, cache = {}, {}, {}

    def get(mesh, k, bc):
        if (mesh, k, bc) in cache:
            return cache[mesh, k, bc]
        if mesh not in meshes:
            meshes[mesh] = {pkg: _MESHES[mesh](g)
                            for pkg, g in (("jax", jgen), ("torch", tgen))}
        out = {}
        jm = meshes[mesh]["jax"]
        p = _problem("jax", jm, k, bc)
        solver = JaxPoisson(p["V"])
        uh = solver.solve(p["rhs"][0], p["prime"], _u, neumann=p["neumann"],
                          rtol=1e-13)
        sp = jfem.local_projection(p["Vf"], [-1.0 * jfem.grad(uh)])
        if (mesh, k) not in engines:
            engines[mesh, k] = JaxEngine(jfem.FunctionSpace(jm, "RT", k),
                                         jax_patches(jm))
        out["jax"] = dict(mesh=jm, p=p, uh=uh, sp=sp, iterations=(
            solver.last_iterations), **{
            name: _equilibrate("jax", Eqlb, k, jm, p, sp, engines[mesh, k])
            for name, Eqlb in (("SE", jeqlb.FluxEqlbSE),
                               ("EV", jeqlb.FluxEqlbEV))})
        tm = meshes[mesh]["torch"]
        p = _problem("torch", tm, k, bc)
        uh = tfem.Function(p["V"], np.asarray(uh.x), device="cpu")
        sp = tfem.local_projection(p["Vf"], [-1.0 * tfem.grad(uh)])
        out["torch"] = dict(mesh=tm, p=p, uh=uh, sp=sp, **{
            name: _equilibrate("torch", Eqlb, k, tm, p, sp)
            for name, Eqlb in (("SE", teqlb.FluxEqlbSE),
                               ("EV", teqlb.FluxEqlbEV))})
        cache[mesh, k, bc] = out
        return out

    return get


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("bc", ["dirichlet", "neumann_inhom"])
def test_poisson_matches_jax(flows, mesh, k, bc):
    """The port's primal solve on the port's projected data: uh within
    1e-10 * max(1, max|u|), CG iterations within one of JAX's."""
    fl = flows(mesh, k, bc)
    j, t = fl["jax"], fl["torch"]
    _close(t["p"]["rhs"][0].x, j["p"]["rhs"][0].x)
    solver = PoissonSolver(t["p"]["V"], device="cpu")
    uh = solver.solve(t["p"]["rhs"][0], t["p"]["prime"], _u,
                      neumann=t["p"]["neumann"], rtol=1e-13)
    assert uh.x.device.type == "cpu" and uh.x.dtype == torch.float64
    _close(uh.x, j["uh"].x, rel=1e-10)
    assert abs(solver.last_iterations - j["iterations"]) <= 1
    assert solver.last_residual <= 1e-12 * max(
        1.0, float(torch.linalg.norm(solver.load_vector(t["p"]["rhs"][0]))))
    np.testing.assert_array_equal(
        locate_dofs_on_facets(t["p"]["V"], t["p"]["prime"]),
        jax_locate(j["p"]["V"], j["p"]["prime"]))


def _check_equilibrator(fl, name):
    j, t = fl["jax"], fl["torch"]
    _close(t["sp"][0].x, j["sp"][0].x)
    jeq, teq = j[name], t[name]
    assert teq.V_flux.family == jeq.V_flux.family
    assert len(teq.list_flux) == len(jeq.list_flux) == 1
    _close(teq.list_flux[0].x, jeq.list_flux[0].x)
    assert len(teq.list_bfunctions) == len(jeq.list_bfunctions)
    for tb, jb in zip(teq.list_bfunctions, jeq.list_bfunctions):
        _close(tb.x, jb.x)
    np.testing.assert_array_equal(teq.boundary_data.facet_kind,
                                  jeq.boundary_data.facet_kind)
    _close(teq.boundary_data.bvals, jeq.boundary_data.bvals)


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("bc", _BCS)
@pytest.mark.parametrize("name", ["SE", "EV"])
def test_equilibrator_matches_jax(flows, mesh, k, bc, name):
    _check_equilibrator(flows(mesh, k, bc), name)


@pytest.mark.parametrize("name", ["SE", "EV"])
def test_equilibrator_degree4_matches_jax(flows, name):
    """k = 4: every reduced system past K1's tile split."""
    torch.set_num_threads(1)
    try:
        _check_equilibrator(flows("crossed", 4, "neumann_inhom"), name)
    finally:
        torch.set_num_threads(2)


_MULTI = [
    (lambda x: 1.0 + x[..., 0],
     lambda x: np.stack([x[..., 1], -x[..., 0]], -1)),
    (lambda x: x[..., 1] ** 2,
     lambda x: np.stack([x[..., 0] * x[..., 1], x[..., 0]], -1)),
    (lambda x: np.sin(x[..., 0]),
     lambda x: np.stack([np.cos(x[..., 1]), x[..., 1]], -1)),
]


@pytest.fixture(scope="module")
def multirhs():
    """multirhs(k) -> per package the mesh and the projected data of three
    fields (tests/test_multirhs.py's), and one JAX engine per k."""
    cache = {}

    def get(k):
        if k not in cache:
            out = {}
            for pkg, g in (("jax", jgen), ("torch", tgen)):
                fem = _PKG[pkg][0]
                kw = {"device": "cpu"} if pkg == "torch" else {}
                msh = g.permute_vertices(g.unit_square(3), seed=17)
                rhs = fem.local_projection(
                    fem.FunctionSpace(msh, "DG", k - 1),
                    [f for f, _ in _MULTI], quadrature_degree=8, **kw)
                proj = fem.local_projection(
                    fem.FunctionSpace(msh, "DG", k - 1, vs=2),
                    [fem.expr_from_callable(v, msh, 2) for _, v in _MULTI],
                    quadrature_degree=8, **kw)
                out[pkg] = (msh, rhs, proj)
            msh = out["jax"][0]
            out["engine"] = JaxEngine(jfem.FunctionSpace(msh, "RT", k),
                                      jax_patches(msh))
            cache[k] = out
        return cache[k]

    return get


@pytest.mark.parametrize("k", [2])
@pytest.mark.parametrize("name", ["SE", "EV"])
def test_multirhs_matches_jax(multirhs, k, name):
    """Three fields in one equilibrator: each of the port's fluxes matches
    JAX's and the port's own single-field equilibration."""
    data = multirhs(k)
    n = len(_MULTI)
    out = {}
    for pkg, mod in (("jax", jeqlb), ("torch", teqlb)):
        msh, rhs, proj = data[pkg]
        eq = getattr(mod, f"FluxEqlb{name}")(k, msh, rhs, proj)
        if pkg == "jax":
            eq.engine = data["engine"]
        eq.set_boundary_conditions([msh.boundary_facets] * n, [[]] * n)
        eq.equilibrate_fluxes()
        out[pkg] = eq
    msh, rhs, proj = data["torch"]
    for i in range(n):
        _close(out["torch"].list_flux[i].x, out["jax"].list_flux[i].x)
        one = getattr(teqlb, f"FluxEqlb{name}")(k, msh, [rhs[i]], [proj[i]])
        one.set_boundary_conditions([msh.boundary_facets], [[]])
        one.equilibrate_fluxes()
        _close(out["torch"].list_flux[i].x, one.list_flux[0].x)


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("bc", _BCS)
def test_checks_match_jax(flows, mesh, k, bc):
    """The checks give JAX's booleans and error values on the same fluxes."""
    fl = flows(mesh, k, bc)
    j, t = fl["jax"], fl["torch"]
    assert (tchecks.mesh_has_reversed_edges(t["mesh"])
            == jchecks.mesh_has_reversed_edges(j["mesh"]))
    pts = np.array([[0.25, 0.25], [0.1, 0.6], [0.4, 0.55]])
    for name in ("SE", "EV"):
        args_t = (t[name].list_flux[0], t["sp"][0])
        args_j = (j[name].list_flux[0], j["sp"][0])
        _close(tchecks.reconstructed_flux_expr(*args_t).evaluate(pts),
               jchecks.reconstructed_flux_expr(*args_j).evaluate(pts))
        rt, rj = t["p"]["rhs"][0], j["p"]["rhs"][0]
        err_t = tchecks.check_divergence_condition(*args_t, rt,
                                                   return_error=True)
        err_j = jchecks.check_divergence_condition(*args_j, rj,
                                                   return_error=True)
        assert abs(err_t - err_j) <= 1e-11
        for fn in ("check_divergence_condition",):
            assert getattr(tchecks, fn)(*args_t, rt) == getattr(
                jchecks, fn)(*args_j, rj)
        for fn in ("check_jump_condition", "check_jump_condition_per_facet"):
            assert getattr(tchecks, fn)(*args_t) == getattr(jchecks, fn)(
                *args_j)
        bf = np.where(j[name].boundary_data.facet_kind[0] == 2)[0]
        if len(bf):
            assert tchecks.check_boundary_conditions(
                *args_t, t[name].list_bfunctions[0], bf
            ) == jchecks.check_boundary_conditions(
                *args_j, j[name].list_bfunctions[0], bf)
    # SE and EV solve the same minimisation (tests/test_eqlb_conditions.py)
    v_se = tchecks.reconstructed_flux_expr(t["SE"].list_flux[0],
                                           t["sp"][0]).evaluate(pts)
    v_ev = tchecks.reconstructed_flux_expr(t["EV"].list_flux[0],
                                           t["sp"][0]).evaluate(pts)
    assert torch.allclose(v_se, v_ev, atol=1e-9)


@pytest.mark.parametrize("mesh", sorted(_MESHES))
def test_check_failures_match_jax(flows, mesh):
    """Broken fluxes fail the checks in both packages alike: a perturbed
    corrector breaks the divergence and jump conditions, perturbed boundary
    data the BC check."""
    fl = flows(mesh, 2, "neumann_inhom")
    j, t = fl["jax"], fl["torch"]
    rng = np.random.default_rng(7)
    noise = 1e-3 * rng.normal(size=j["SE"].list_flux[0].x.shape)
    js = jfem.Function(j["SE"].V_flux, np.asarray(j["SE"].list_flux[0].x)
                       + noise)
    ts = tfem.Function(t["SE"].V_flux, t["SE"].list_flux[0].x.numpy()
                       + noise, device="cpu")
    rt, rj = t["p"]["rhs"][0], j["p"]["rhs"][0]
    for fn in ("check_jump_condition", "check_jump_condition_per_facet"):
        assert not getattr(tchecks, fn)(ts, t["sp"][0])
        assert not getattr(jchecks, fn)(js, j["sp"][0])
    assert not tchecks.check_divergence_condition(ts, t["sp"][0], rt)
    assert not jchecks.check_divergence_condition(js, j["sp"][0], rj)
    err_t = tchecks.check_divergence_condition(ts, t["sp"][0], rt,
                                               return_error=True)
    err_j = jchecks.check_divergence_condition(js, j["sp"][0], rj,
                                               return_error=True)
    assert abs(err_t - err_j) <= 1e-11
    bf = np.where(j["EV"].boundary_data.facet_kind[0] == 2)[0]
    jb = jfem.Function(j["EV"].list_bfunctions[0].space,
                       np.asarray(j["EV"].list_bfunctions[0].x) + 1e-3)
    tb = tfem.Function(t["EV"].list_bfunctions[0].space,
                       t["EV"].list_bfunctions[0].x + 1e-3)
    assert not tchecks.check_boundary_conditions(
        t["EV"].list_flux[0], t["sp"][0], tb, bf)
    assert not jchecks.check_boundary_conditions(
        j["EV"].list_flux[0], j["sp"][0], jb, bf)


@pytest.mark.parametrize("k", [1, 2])
def test_checks_share_device_tables(flows, k):
    """The checks evaluate through the mesh's one RT space, the
    equilibrators' own, so repeated checks upload no dofmap again; the
    error helpers give the checks' verdicts under their default
    tolerances."""
    t = flows("permuted", k, "neumann_inhom")["torch"]
    msh, se, ev = t["mesh"], t["SE"], t["EV"]
    V_rt = tfem.spaces.mesh_space(msh, "RT", k)
    assert se._V_rt is ev._V_rt is V_rt
    args = (se.list_flux[0], t["sp"][0])
    rhs = t["p"]["rhs"][0]
    assert tchecks.check_jump_condition(*args)
    tables = tfem.spaces.space_tables(V_rt, "cpu")
    err = tchecks.jump_error(*args)
    assert tfem.spaces.space_tables(V_rt, "cpu") is tables
    assert list(V_rt._torch_tables) == ["cpu"]
    assert (err < tchecks.JUMP_ATOL) == tchecks.check_jump_condition(*args)
    assert err == tchecks.check_jump_condition(*args, return_error=True)
    err, scale = tchecks.divergence_error(*args, rhs)
    assert err == tchecks.check_divergence_condition(*args, rhs,
                                                     return_error=True)
    assert ((err < tchecks.DIVERGENCE_ATOL * scale)
            == tchecks.check_divergence_condition(*args, rhs))


@pytest.mark.parametrize("symmetric", [True, False])
def test_weak_symmetry_check_matches_jax(symmetric):
    """Two vector DG rows (a, b) and (b', c): weakly symmetric iff b = b'."""
    rng = np.random.default_rng(3)
    out = []
    for pkg, g in (("jax", jgen), ("torch", tgen)):
        fem = _PKG[pkg][0]
        msh = g.permute_vertices(g.unit_square(3), seed=13)
        V = fem.FunctionSpace(msh, "DG", 1, vs=2)
        n = V.ndofs_scalar
        a, b, c = (np.random.default_rng(s).normal(size=n) for s in (1, 2, 3))
        b2 = b if symmetric else b + 0.1 * rng.normal(size=n)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        rows = [fem.Function(V, np.concatenate([a, b]), **kw),
                fem.Function(V, np.concatenate([b2, c]), **kw)]
        mod = tchecks if pkg == "torch" else jchecks
        out.append(mod.check_weak_symmetry_condition(rows))
    assert out[0] == out[1] == symmetric


def test_stress_and_korn_not_ported(flows):
    """The name is kept from when stress and Korn constants raised
    NotImplementedError; since they are ported the test holds the JAX
    package's behaviour (``eqlb/equilibrators.py:157-158, 169-171``): stress
    equilibration needs two flux rows and flux degree >= 2, and
    ``estimate_korn_constant=True`` alone adds the Korn constants to a flux
    equilibration, equal to JAX's."""
    t = flows("crossed", 1, "dirichlet")["torch"]
    rhs, sp = t["p"]["rhs"], t["sp"]
    with pytest.raises(ValueError, match="gdim flux rows"):
        teqlb.FluxEqlbSE(1, t["mesh"], rhs, sp, equilibrate_stress=True)
    eq = teqlb.FluxEqlbSE(1, t["mesh"], rhs * 2, sp * 2,
                          equilibrate_stress=True)
    with pytest.raises(ValueError, match="flux degree >= 2"):
        eq.equilibrate_fluxes()
    j = flows("crossed", 2, "dirichlet")
    eq = teqlb.FluxEqlbSE(2, j["torch"]["mesh"], j["torch"]["p"]["rhs"],
                          j["torch"]["sp"], estimate_korn_constant=True)
    eq.set_boundary_conditions([j["torch"]["p"]["prime"]],
                               [j["torch"]["p"]["bcs"]])
    eq.equilibrate_fluxes()
    _close(eq.list_flux[0].x, j["jax"]["SE"].list_flux[0].x)
    from dolfinx_eqlb_tpu.eqlb.korn import estimate_korn_constants

    _close(eq.get_korn_constants().x,
           estimate_korn_constants(j["jax"]["mesh"]).x, rel=1e-12)


def test_no_card_default_raises(flows, monkeypatch):
    """Without a card and without device="cpu", every new entry point
    raises; the equilibrators follow their data's device."""
    t = flows("crossed", 1, "dirichlet")["torch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = t["p"]["V"]
    for call in (lambda: tfem.Function(V),
                 lambda: tfem.Function(V, np.zeros(V.ndofs)),
                 lambda: tfem.local_projection(V, [_f]),
                 lambda: tfem.interpolate(V, _u),
                 lambda: tfem.assemble_scalar(tfem.as_expr(_f, t["mesh"]), 4),
                 lambda: PoissonSolver(V)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    eq = teqlb.FluxEqlbEV(1, t["mesh"], t["p"]["rhs"], t["sp"])
    assert eq.device.type == "cpu" and eq.engine.device.type == "cpu"
    # a Function's data keeps its device through the expressions
    (proj,) = tfem.local_projection(t["p"]["Vf"], [-1.0 * tfem.grad(t["uh"])])
    assert proj.x.device.type == "cpu"


def test_create_hierarchic_rt():
    from dolfinx_eqlb_tpu.elmtlib import create_hierarchic_rt as jrt

    for degree in (1, 2, 3):
        t, j = create_hierarchic_rt(degree=degree), jrt(degree=degree)
        pts = np.array([[0.2, 0.3], [0.5, 0.25]])
        np.testing.assert_array_equal(t.tabulate(pts), j.tabulate(pts))
    with pytest.raises(ValueError):
        create_hierarchic_rt("quadrilateral", 2)
