"""Host layer of the PyTorch port against the JAX package: the copied NumPy
modules (mesh generators, patch extraction, dof tables, explicit-step
tables, reference tensors) must produce identical arrays."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu.eqlb import engine as jeng
from dolfinx_eqlb_tpu.eqlb import patches as jpat
from dolfinx_eqlb_tpu.eqlb import semiexplicit as jse
from dolfinx_eqlb_tpu.fem import FunctionSpace as JV
from dolfinx_eqlb_tpu import native as jnative
from dolfinx_eqlb_tpu.mesh import generators as jgen

from dolfinx_eqlb_tpu_torch import native as tnative
from dolfinx_eqlb_tpu_torch.eqlb import engine as teng
from dolfinx_eqlb_tpu_torch.eqlb import patches as tpat
from dolfinx_eqlb_tpu_torch.eqlb import semiexplicit as tse
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace as TV
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

_MESH_ATTRS = [
    "points", "cells", "num_cells", "num_vertices", "num_facets",
    "facet_vertices", "cell_facets", "facet_cells", "facet_local",
    "edge_aligned", "is_boundary_facet", "boundary_facets", "v2c_offsets",
    "v2c_data", "v2f_offsets", "v2f_data", "is_boundary_vertex", "J",
    "detJ", "K", "cell_volumes", "facet_tangent", "facet_length", "h_cell",
    "boundary_outward_sign",
]

_MESHES = {
    "crossed4": lambda g: g.unit_square(4),
    "right4": lambda g: g.unit_square(4, "right"),
    "unstructured4": lambda g: g.unit_square_unstructured(4),
}


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for name in a:
            _assert_same(a[name], b[name], f"{what}[{name}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(params=sorted(_MESHES))
def meshes(request):
    make = _MESHES[request.param]
    return make(jgen), make(tgen)


def test_port_native_library_loads():
    assert tnative.available()


def test_mesh_arrays_identical(meshes):
    jm, tm = meshes
    for attr in _MESH_ATTRS:
        _assert_same(getattr(jm, attr), getattr(tm, attr), attr)


def test_build_patches_identical(meshes):
    jm, tm = meshes
    jb, tb = jpat.build_patches(jm), tpat.build_patches(tm)
    assert jb.keys() == tb.keys()
    for key in jb:
        _assert_same(dataclasses.asdict(jb[key]), dataclasses.asdict(tb[key]),
                     str(key))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_dof_and_se_tables_identical(meshes, k):
    jm, tm = meshes
    jV, tV = JV(jm, "RT", k), TV(tm, "RT", k)
    _assert_same(jV.cell_dofs, tV.cell_dofs, "cell_dofs")
    _assert_same(jV.dof_signs, tV.dof_signs, "dof_signs")
    jb, tb = jpat.build_patches(jm), tpat.build_patches(tm)
    for key in jb:
        jt = jpat.bucket_dof_tables(jb[key], jV)
        tt = tpat.bucket_dof_tables(tb[key], tV)
        _assert_same(jt, tt, f"bucket_dof_tables {key}")
        _assert_same(jse.se_static(jb[key], k), tse.se_static(tb[key], k),
                     f"se_static {key}")
        _assert_same(jse.se_host_tables(jb[key], jt, jm, k),
                     tse.se_host_tables(tb[key], tt, tm, k),
                     f"se_host_tables {key}")


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_numpy_fallbacks_identical(name, monkeypatch):
    """Without the native libraries, the port's NumPy fallbacks (facets,
    patch walk, permutations and signs) give the same arrays as the JAX
    package's, and on a given mesh the patch walk and the combine table
    equal the native route's."""
    tm = _MESHES[name](tgen)
    tV = TV(tm, "RT", 2)
    tb_native = tpat.build_patches(tm)
    src_native = teng.EqlbEngine(tV, tb_native, device="cpu")._src
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert not (jnative.available() or tnative.available())
    tb = tpat.build_patches(tm)
    for key in tb_native:
        _assert_same(dataclasses.asdict(tb_native[key]),
                     dataclasses.asdict(tb[key]), str(key))
    _assert_same(src_native, teng.EqlbEngine(tV, tb, device="cpu")._src, "combine src")

    jm, fm = _MESHES[name](jgen), _MESHES[name](tgen)
    for attr in _MESH_ATTRS:
        _assert_same(getattr(jm, attr), getattr(fm, attr), attr)
    jb, fb = jpat.build_patches(jm), tpat.build_patches(fm)
    assert jb.keys() == fb.keys()
    jV, fV = JV(jm, "RT", 2), TV(fm, "RT", 2)
    for key in jb:
        _assert_same(dataclasses.asdict(jb[key]), dataclasses.asdict(fb[key]),
                     str(key))
        _assert_same(jpat.bucket_dof_tables(jb[key], jV),
                     tpat.bucket_dof_tables(fb[key], fV),
                     f"bucket_dof_tables {key}")


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_reference_tensors_identical(k):
    _assert_same(jeng.reference_tensors(k), teng.reference_tensors(k),
                 "reference_tensors")
    _assert_same(jse.combo_tensors(k), tse.combo_tensors(k), "combo_tensors")


def test_port_imports_without_jax():
    code = ("import sys, dolfinx_eqlb_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_port_sources_never_import_jax():
    for path in (REPO / "dolfinx_eqlb_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or "dolfinx_eqlb_tpu." in s and "import" in s
                        and "dolfinx_eqlb_tpu_torch" not in s), (path, line)
