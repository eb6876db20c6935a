"""I/O and tooling of the port against the JAX package's, on the CPU:

* ``mesh.read_msh`` (Gmsh v2.2 and v4.1): points, cells, facet and cell
  tags identical to JAX's on ``tests/test_msh_io.py``'s texts, and that
  file's three specs on the port (equilibration on the imported mesh
  included);
* ``utils.write_vtu``: byte for byte JAX's file;
* ``utils.write_xdmf``: with ``h5py`` the ``.xdmf`` text and the ``.h5``
  file byte for byte JAX's; with ``h5py`` hidden (the inline-XML route)
  the same numbers as JAX's, written as plain numbers (JAX's, under
  NumPy 2, carry ``np.float64(...)``);
* ``utils.flux_cell_values`` within 1e-12 of JAX's;
* ``utils.sync`` / ``timed`` / ``trace`` on CPU tensors;
* ``eqlb.patches.build_patches_reference`` array for array JAX's on the
  meshes of ``tests/test_patches.py``, and ``build_patches`` held to it as
  that test holds JAX's;
* the package exports (``utils``, ``mesh.read_msh``, ``parallel``) and the
  demos' ParaView output (``demos.reconstruction --outdir``, the
  ``demos.biot`` pressure XDMF)."""

import json
import re
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.eqlb import patches as jpatches
from dolfinx_eqlb_tpu.mesh import generators as jgen
from dolfinx_eqlb_tpu.mesh.msh_io import read_msh as jax_read_msh
from dolfinx_eqlb_tpu.utils import io as jio

from dolfinx_eqlb_tpu_torch import eqlb as teqlb
from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.eqlb import patches as tpatches
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen
from dolfinx_eqlb_tpu_torch.mesh import read_msh
from dolfinx_eqlb_tpu_torch.utils import io as tio

from tests.test_msh_io import MSH_V2, MSH_V4

torch.set_num_threads(2)


# --- Gmsh import -------------------------------------------------------------

@pytest.mark.parametrize("text", [MSH_V2, MSH_V4], ids=["v2", "v4"])
def test_read_msh_identical_to_jax(text):
    msh, ft, ct = read_msh(text)
    jmsh, jft, jct = jax_read_msh(text)
    for name in ("points", "cells", "facet_vertices", "cell_facets",
                 "boundary_facets"):
        a, b = getattr(msh, name), getattr(jmsh, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for mine, ref in ((ft, jft), (ct, jct)):
        assert mine.keys() == ref.keys()
        for tag in ref:
            assert np.array_equal(mine[tag], ref[tag])


def test_read_msh_from_path(tmp_path):
    path = tmp_path / "square.msh"
    path.write_text(MSH_V4)
    msh, ft, _ = read_msh(str(path))
    assert msh.num_cells == 4 and sorted(ft) == [10, 20]


def _check_tags(msh, facet_tags):
    """tests/test_msh_io.py's ``_check`` on the port's mesh."""
    assert msh.num_cells == 4
    assert msh.num_vertices == 5
    assert len(facet_tags[10]) == 1
    assert len(facet_tags[20]) == 3
    fv = msh.facet_vertices[facet_tags[10][0]]
    assert np.allclose(msh.points[fv][:, 0], 0.0)
    allb = np.concatenate([facet_tags[10], facet_tags[20]])
    assert set(allb) == set(msh.boundary_facets.tolist())


def test_read_msh_v2_spec():
    msh, ft, ct = read_msh(MSH_V2)
    _check_tags(msh, ft)
    assert len(ct[1]) == 4


def test_read_msh_v4_spec():
    msh, ft, _ = read_msh(MSH_V4)
    _check_tags(msh, ft)


def test_equilibrate_on_imported_mesh_spec():
    msh, _, _ = read_msh(MSH_V2)
    k = 2
    Vr = tfem.FunctionSpace(msh, "DG", k - 1)
    Vf = tfem.FunctionSpace(msh, "DG", k - 1, vs=2)
    rhs = tfem.local_projection(Vr, [lambda x: np.ones(x.shape[:-1])],
                                device="cpu")
    proj = tfem.local_projection(Vf, [tfem.expr_from_callable(
        lambda x: 0.5 * np.stack([x[..., 0], x[..., 1]], -1), msh,
        value_size=2)], device="cpu")
    eq = teqlb.FluxEqlbSE(k, msh, rhs, proj)
    eq.set_boundary_conditions([msh.boundary_facets], [[]])
    eq.equilibrate_fluxes()
    assert teqlb.check_divergence_condition(eq.list_flux[0], proj[0],
                                            rhs[0])


# --- ParaView output ---------------------------------------------------------

def _fields(seed=0, n=3):
    """A small mesh in both packages and NumPy point / cell data."""
    tmsh, jmsh = tgen.unit_square(n), jgen.unit_square(n)
    rng = np.random.default_rng(seed)
    point = {"u": rng.normal(size=tmsh.num_vertices)}
    cell = {"eta": rng.normal(size=tmsh.num_cells),
            "sigma": rng.normal(size=(tmsh.num_cells, 2))}
    return tmsh, jmsh, point, cell


def test_write_vtu_bytes_equal_jax(tmp_path):
    tmsh, jmsh, point, cell = _fields()
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    tio.write_vtu(str(tmp_path / "a" / "out.vtu"), tmsh,
                  {k: torch.as_tensor(v) for k, v in point.items()},
                  {k: torch.as_tensor(v) for k, v in cell.items()})
    jio.write_vtu(str(tmp_path / "b" / "out.vtu"), jmsh, point, cell)
    assert ((tmp_path / "a" / "out.vtu").read_bytes()
            == (tmp_path / "b" / "out.vtu").read_bytes())


def test_write_xdmf_h5py_bytes_equal_jax(tmp_path):
    pytest.importorskip("h5py")
    tmsh, jmsh, point, cell = _fields(seed=1)
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
    tio.write_xdmf(str(tmp_path / "a" / "out.xdmf"), tmsh,
                   {k: torch.as_tensor(v) for k, v in point.items()}, cell)
    jio.write_xdmf(str(tmp_path / "b" / "out.xdmf"), jmsh, point, cell)
    for name in ("out.xdmf", "out.h5"):
        assert ((tmp_path / "a" / name).read_bytes()
                == (tmp_path / "b" / name).read_bytes()), name


_NUM = re.compile(r"^-?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?$|^-?inf$|^nan$")


def _inline_items(text):
    """Every inline DataItem's whitespace-separated tokens, in order."""
    root = ET.fromstring(text)
    return [item.text.split() for item in root.iter("DataItem")]


def test_write_xdmf_inline_route(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # hides h5py
    tmsh, jmsh, point, cell = _fields(seed=2)
    tio.write_xdmf(str(tmp_path / "port.xdmf"), tmsh, point, cell)
    jio.write_xdmf(str(tmp_path / "jax.xdmf"), jmsh, point, cell)
    assert not (tmp_path / "port.h5").exists()
    mine = (tmp_path / "port.xdmf").read_text()
    ref = (tmp_path / "jax.xdmf").read_text()
    assert "np.float64(" not in mine and "np.int64(" not in mine
    ours, theirs = _inline_items(mine), _inline_items(ref)
    assert len(ours) == len(theirs) == 2 + len(point) + len(cell)
    for a, b in zip(ours, theirs):
        assert all(_NUM.match(tok) for tok in a)
        # the reference's tokens, with any NumPy scalar repr unwrapped
        b = [re.sub(r"^np\.\w+\((.*)\)$", r"\1", tok) for tok in b]
        assert np.array_equal(np.array(a, dtype=float),
                              np.array(b, dtype=float))
    # the markup around the data is the reference's
    strip = re.compile(r'Format="XML">.*?</DataItem>', re.S)
    assert strip.sub("", mine) == strip.sub("", ref)


def test_flux_cell_values_match_jax():
    n, k = 3, 2
    tmsh, jmsh = tgen.unit_square(n), jgen.unit_square(n)
    rng = np.random.default_rng(3)
    for fam in ("RT", "DRT"):
        tV, jV = tfem.FunctionSpace(tmsh, fam, k), jfem.FunctionSpace(
            jmsh, fam, k)
        tD = tfem.FunctionSpace(tmsh, "DG", k - 1, vs=2)
        jD = jfem.FunctionSpace(jmsh, "DG", k - 1, vs=2)
        xe, xp = rng.normal(size=tV.ndofs), rng.normal(size=tD.ndofs)
        te, je = tfem.Function(tV, xe, device="cpu"), jfem.Function(jV, xe)
        tp, jp = tfem.Function(tD, xp, device="cpu"), jfem.Function(jD, xp)
        for args_t, args_j in (((te,), (je,)), ((te, tp), (je, jp))):
            got = tio.flux_cell_values(*args_t)
            want = jio.flux_cell_values(*args_j)
            assert isinstance(got, np.ndarray) and got.shape == (
                tmsh.num_cells, 2)
            assert np.abs(got - np.asarray(want)).max() <= 1e-12


def test_demo_reconstruction_writes_paraview_output(tmp_path, capsys):
    from dolfinx_eqlb_tpu_torch.demos import reconstruction as demo

    out = tmp_path / "out"
    demo.main(["--n", "4", "--degree", "2", "--order-prime", "2",
               "--device", "cpu", "--outdir", str(out)])
    assert "ParaView output written" in capsys.readouterr().out
    root = ET.parse(out / "reconstruction.xdmf").getroot()
    names = {a.get("Name") for a in root.iter("Attribute")}
    assert names == {"u", "sigma_proj", "sigma_R"}
    vtu = ET.parse(out / "reconstruction.vtu").getroot()
    arrays = {d.get("Name") for d in vtu.iter("DataArray")}
    assert {"u", "sigma_proj", "sigma_R"} <= arrays


# --- profiling ---------------------------------------------------------------

def test_sync_on_cpu_tensors():
    from dolfinx_eqlb_tpu_torch.utils import sync

    a, b = torch.ones(3), torch.zeros(2)
    assert sync(a) is a
    assert sync(a, b) == (a, b)
    assert sync(a, np.ones(2))[0] is a


def test_timed_records_seconds(capsys):
    from dolfinx_eqlb_tpu_torch.utils import timed

    with timed("block") as t:
        torch.ones(1000).sum()
    assert t["name"] == "block" and t["s"] >= 0.0
    assert "[block]" in capsys.readouterr().out


def test_trace_writes_chrome_trace(tmp_path):
    """The trace holds the profiler's events and the program's spans: one
    tiny engine call's ``eqlb.call`` on the trace's time base, around the
    operators the call ran."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.utils import trace

    msh = tgen.unit_square(2)
    eng = EqlbEngine(tfem.FunctionSpace(msh, "RT", 1),
                     tpatches.build_patches(msh), dtype=torch.float64,
                     device="cpu")
    nc, nf = msh.num_cells, msh.num_facets
    inputs = (torch.ones(1, nc, 2, 1, dtype=torch.float64),
              torch.ones(1, nc, 1, dtype=torch.float64),
              np.zeros((1, nf), dtype=np.int8), np.zeros((1, nf, 1)))
    eng.equilibrate(*inputs)
    with trace(str(tmp_path / "tr")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        eng.equilibrate(*inputs)
    assert prof.chrome_trace == str(tmp_path / "tr" / "trace.json")
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert events["traceEvents"]
    names = {e.key for e in prof.key_averages()}
    assert any("mm" in name for name in names)
    calls = [e for e in events["traceEvents"] if e.get("name") == "eqlb.call"]
    assert len(calls) == 1 and calls[0]["ph"] == "X"
    assert calls[0]["args"]["buckets"] == len(eng.buckets)
    t0, t1 = calls[0]["ts"], calls[0]["ts"] + calls[0]["dur"]
    inside = [e for e in events["traceEvents"]
              if e.get("cat") == "cpu_op" and t0 <= e["ts"] <= t1]
    assert any(e["name"] == "aten::cat" for e in inside)
    assert {r.name for r in prof.spans} >= {"eqlb.call", "se.bucket"}


# --- patch builder reference walk --------------------------------------------

_PATCH_MESHES = [
    lambda g: g.unit_square(5),
    lambda g: g.permute_vertices(g.unit_square(5), seed=9),
    lambda g: g.lshape(3),
]


@pytest.mark.parametrize("mesh_fn", _PATCH_MESHES,
                         ids=["square", "permuted", "lshape"])
def test_build_patches_reference_identical_to_jax(mesh_fn):
    mine = tpatches.build_patches_reference(mesh_fn(tgen))
    ref = jpatches.build_patches_reference(mesh_fn(jgen))
    assert list(mine) == list(ref)
    for key in ref:
        for name in ("ncells", "is_boundary", "nodes", "cells", "lnode",
                     "spokes", "entry_loc", "exit_loc"):
            a, b = getattr(mine[key], name), getattr(ref[key], name)
            assert np.array_equal(a, b), (key, name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, (key, name)


@pytest.mark.parametrize("mesh_fn", _PATCH_MESHES,
                         ids=["square", "permuted", "lshape"])
def test_build_patches_matches_reference_walk(mesh_fn):
    """tests/test_patches.py's spec on the port."""
    msh = mesh_fn(tgen)
    fast = tpatches.build_patches(msh)
    ref = tpatches.build_patches_reference(msh)
    assert set(fast.keys()) == set(ref.keys())
    for key in ref:
        bf, br = fast[key], ref[key]
        assert set(bf.nodes.tolist()) == set(br.nodes.tolist())
        of, orf = np.argsort(bf.nodes), np.argsort(br.nodes)
        assert (np.sort(bf.cells[of], 1) == np.sort(br.cells[orf], 1)).all()
        assert (np.sort(bf.spokes[of], 1)
                == np.sort(br.spokes[orf], 1)).all()
        if key[1]:  # boundary: the walk direction is forced
            for name in ("cells", "lnode", "spokes", "entry_loc",
                         "exit_loc"):
                assert (getattr(bf, name)[of]
                        == getattr(br, name)[orf]).all(), name
        n, ns = bf.ncells, bf.nspokes
        for p in range(min(5, bf.npatches)):
            for i in range(n):
                c = bf.cells[p, i]
                assert msh.cell_facets[c, bf.entry_loc[p, i]] == \
                    bf.spokes[p, i]
                assert msh.cell_facets[c, bf.exit_loc[p, i]] == \
                    bf.spokes[p, (i + 1) % ns]
                assert msh.cells[c, bf.lnode[p, i]] == bf.nodes[p]


# --- package exports ---------------------------------------------------------

def test_package_exports():
    from dolfinx_eqlb_tpu import utils as jutils
    from dolfinx_eqlb_tpu_torch import mesh as tmesh
    from dolfinx_eqlb_tpu_torch import parallel as tpar
    from dolfinx_eqlb_tpu_torch import utils as tutils

    for name in ("run_perftest", "timed", "trace", "sync", "write_vtu",
                 "write_xdmf", "flux_cell_values"):
        assert callable(getattr(tutils, name)), name
        assert hasattr(jutils, name), name
    assert tmesh.read_msh is read_msh
    assert callable(tpar.ShardedEqlbEngine)
    assert callable(tpar.spawn_ranks)
