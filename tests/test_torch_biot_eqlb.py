"""The 3-field Biot equilibration on the port against the JAX package's,
f64 on the CPU:

* ``FluxEqlbSE(equilibrate_stress=True)`` over the two stress rows and
  the Darcy flux, on JAX's projected fields (from JAX's Jacobi MINRES
  solve, rtol 1e-13) on the crossed ``unit_square(4)`` and on
  ``unit_square_unstructured(5, seed=3)``: the correctors within 1e-11
  (relative to max(1, max|.|)) of JAX's, and the divergence (at the
  checks' default 1e-8), jump and weak-symmetry checks holding, as JAX's
  do;
* ``demos.biot``'s main with ``--device cpu --n 4``;
* ``run_perftest`` on the CPU (orders (1, 2), n0 = 2, nrefs = 2, all
  three cases; the stress cases skip order 1): its structural columns
  (ncells, nnodes, ndofs_prime) equal to those of the JAX harness's
  set-ups on the same meshes, its CSV header the reference's columns, and
  its times finite."""

import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import eqlb as jeqlb
from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.mesh import generators as jgen
from dolfinx_eqlb_tpu.models import biot as jbiot
from dolfinx_eqlb_tpu.utils import perftest as jperf

from dolfinx_eqlb_tpu_torch import eqlb as teqlb
from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.demos import biot as demo
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen
from dolfinx_eqlb_tpu_torch.utils import perftest as tperf

from tests.test_biot import f_body, g_flow

torch.set_num_threads(2)

_MESHES = {
    "crossed": lambda g: g.unit_square(4),
    "unstructured": lambda g: g.unit_square_unstructured(5, seed=3),
}


def _checks(eqlb, eq, proj, rhs):
    out = {}
    for i in range(3):
        out[f"divergence_{i}"] = bool(eqlb.check_divergence_condition(
            eq.list_flux[i], proj[i], rhs[i]))
        out[f"jump_{i}"] = bool(eqlb.check_jump_condition(eq.list_flux[i],
                                                          proj[i]))
    out["weak_symmetry"] = bool(eqlb.check_weak_symmetry_condition(
        eq.list_flux[:2], proj[:2]))
    return out


@pytest.fixture(scope="module", params=sorted(_MESHES))
def flows(request):
    """JAX: solve, project the three fields, equilibrate them in one call;
    the port: the same equilibration on JAX's projected fields."""
    import jax.numpy as jnp

    k = 2
    msh = _MESHES[request.param](jgen)
    Vu = jfem.FunctionSpace(msh, "P", k, vs=2)
    Vp = jfem.FunctionSpace(msh, "P", k)
    Vpt = jfem.FunctionSpace(msh, "P", k - 1)
    fe = jfem.local_projection(
        jfem.FunctionSpace(msh, "DG", k - 1, vs=2),
        [jfem.expr_from_callable(f_body, msh, value_size=2)],
        quadrature_degree=2 * k + 6)[0]
    ge = jfem.local_projection(
        jfem.FunctionSpace(msh, "DG", k - 1),
        [jfem.expr_from_callable(g_flow, msh, value_size=1)],
        quadrature_degree=2 * k + 6)[0]
    solver = jbiot.BiotSolverUPP(Vu, Vp, Vpt, dtype=jnp.float64)
    uh, ph, pth = solver.solve(fe, ge, msh.boundary_facets, rtol=1e-13)
    proj, rhs = jbiot.biot_fields(uh, ph, pth, fe, ge, k)
    jeq = jeqlb.FluxEqlbSE(k, msh, rhs, proj, equilibrate_stress=True)
    jeq.set_boundary_conditions([msh.boundary_facets] * 3, [[], [], []])
    jeq.equilibrate_fluxes()
    jchecks = _checks(jeqlb, jeq, proj, rhs)

    tmsh = _MESHES[request.param](tgen)

    def port(fs, vs):
        V = tfem.FunctionSpace(tmsh, "DG", k - 1, vs=vs)
        return [tfem.Function(V, torch.tensor(np.asarray(f.x))) for f in fs]

    tproj, trhs = port(proj, 2), port(rhs, 1)
    teq = teqlb.FluxEqlbSE(k, tmsh, trhs, tproj, equilibrate_stress=True)
    teq.set_boundary_conditions([tmsh.boundary_facets] * 3, [[], [], []])
    teq.equilibrate_fluxes()
    return dict(jax=(jeq, jchecks), torch=(teq, _checks(teqlb, teq, tproj,
                                                        trhs)))


def test_three_field_equilibration_matches_jax(flows):
    (jeq, _), (teq, _) = flows["jax"], flows["torch"]
    assert len(teq.list_flux) == 3
    for a, b in zip(teq.list_flux, jeq.list_flux):
        got, want = a.x.numpy(), np.asarray(b.x)
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-11 * max(
            1.0, np.abs(want).max())


def test_three_field_checks_hold(flows):
    jchecks, tchecks = flows["jax"][1], flows["torch"][1]
    assert tchecks == jchecks
    assert all(tchecks.values()), tchecks


def test_demo_main_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    demo.main(["--device", "cpu", "--n", "4"])
    out = capsys.readouterr().out
    assert "weak symmetry of the stress rows: True" in out
    rows = (tmp_path / "Biot_n4_order2.csv").read_text().splitlines()
    assert rows[0] == ",".join(demo.CSV_HEADER)
    assert len(rows) == 4
    for row in rows[1:]:
        field, err, jump, wsym = row.split(",")
        assert float(err) < 1e-8 and jump == "True"
        assert wsym == ("" if field == "Darcy flux" else "True")
    # the reference demo's pressure XDMF
    root = ET.parse(tmp_path / "biot_pressure.xdmf").getroot()
    assert {a.get("Name") for a in root.iter("Attribute")} == {"p", "pt"}


def test_demo_info():
    """The flow on a 3-level hierarchy: block-MG MINRES, every check."""
    info = {}
    demo.run(16, 2, device="cpu", verbose=False, info=info)
    assert len(info["meshes"]) == 3 and info["cells"] == 1024
    assert 0 < info["iterations"] <= 80 and info["maxiter"] == 400
    assert all(info["checks"].values()), info["checks"]


def _jax_structure(testcase, order, n0, nrefs):
    """(ncells, nnodes, ndofs_prime) of each row of the JAX harness: its
    meshes and its set-ups' dof counts, without the timed stages."""
    rows = []
    hierarchy = None
    if testcase != "poisson":
        hierarchy = jfem.mesh_hierarchy(jgen.unit_square(n0), nrefs)
    for i in range(nrefs):
        msh = (hierarchy[i] if hierarchy is not None
               else jgen.unit_square(n0 * 2**i))
        args = (msh, order) if hierarchy is None else (
            msh, order, hierarchy[: i + 1])
        ndofs = jperf._SETUPS[testcase](*args)[0]
        rows.append((msh.num_cells, msh.num_vertices, ndofs))
    return rows


@pytest.mark.parametrize("testcase", list(tperf.TESTCASES))
def test_run_perftest_structure_matches_jax(testcase, tmp_path):
    out = tmp_path / "perftest.csv"
    rows = tperf.run_perftest(testcase, orders=(1, 2), n0=2, nrefs=2,
                              repeats=1, out_csv=str(out), device="cpu")
    orders = [r["order"] for r in rows]
    assert orders == ([1, 1, 2, 2] if testcase == "poisson" else [2, 2])
    got = [(r["ncells"], r["nnodes"], r["ndofs_prime"]) for r in rows
           if r["order"] == 2]
    assert got == _jax_structure(testcase, 2, 2, 2)
    header = out.read_text().splitlines()[0].split(",")
    assert header[:10] == tperf._COLUMNS[:10]
    assert header[10:] == (tperf._COLUMNS[10:] if testcase == "poisson"
                           else tperf._COLUMNS[10:12])
    for r in rows:
        assert all(np.isfinite(v) and v >= 0 for key, v in r.items()
                   if key.startswith(("tp_", "t_")))
