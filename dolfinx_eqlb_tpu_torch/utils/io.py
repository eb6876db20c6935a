"""ParaView output: VTU (XML, base64) and XDMF/HDF5 writers.

Port of the JAX package's ``utils/io.py``: the same files, byte for byte,
from the same mesh and data.  Data may be NumPy arrays or tensors on any
device (taken to the host through ``.cpu()``).  One difference: the
inline-XML route writes every number as a plain Python ``repr``
(``0.5``, ``3``), where the reference, under NumPy 2, writes the NumPy
scalar's ``repr`` (``np.float64(0.5)``), which ParaView cannot read.

The reference's user-facing deliverable is XDMF written with
``dolfinx.io.XDMFFile`` (``python/demo/poisson/demo_reconstruction.py:534-540``
writes the primal solution, projected + equilibrated fluxes; the adaptive
demos write per-level error fields).  This module provides the equivalent for
:class:`~dolfinx_eqlb_tpu_torch.mesh.TriMesh` data without external mesh-IO
dependencies: VTU is plain XML (always available), XDMF uses ``h5py`` for the
heavy arrays when present and falls back to inline-XML data items otherwise.

Data conventions
----------------
``point_data``  name -> array (npoints,) or (npoints, dim); vertex fields
                (P1 nodal values).
``cell_data``   name -> array (ncells,) or (ncells, dim); cell fields (DG0
                values, e.g. error-estimator densities, or fluxes sampled at
                cell midpoints via :func:`flux_cell_values`).
"""

from __future__ import annotations

import base64
import os
import struct

import numpy as np
import torch

__all__ = ["write_vtu", "write_xdmf", "flux_cell_values"]


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a NumPy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _b64(arr: np.ndarray) -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def _pad3(a: np.ndarray) -> np.ndarray:
    """Pad 2-vector data to 3 components (VTK requirement for vectors)."""
    a = np.asarray(_host(a), dtype=np.float64)
    if a.ndim == 1:
        return a
    out = np.zeros((a.shape[0], 3))
    out[:, : a.shape[1]] = a
    return out


def flux_cell_values(sigma_eq, sigma_proj=None) -> np.ndarray:
    """Reconstructed flux evaluated at cell midpoints, (ncells, 2) — the
    cell-data analog of the reference's DG-interpolated flux output."""
    from ..eqlb.checks import reconstructed_flux_expr
    from ..fem.expressions import as_expr

    if sigma_proj is None:
        expr = as_expr(sigma_eq)
    else:
        expr = reconstructed_flux_expr(sigma_eq, sigma_proj)
    mid = np.array([[1.0 / 3.0, 1.0 / 3.0]])
    return _host(expr.evaluate(mid))[:, 0, :]


def write_vtu(path, mesh, point_data=None, cell_data=None) -> str:
    """Write a binary-base64 VTU file ParaView opens directly."""
    point_data = point_data or {}
    cell_data = cell_data or {}
    pts = np.zeros((mesh.num_vertices, 3))
    pts[:, :2] = np.asarray(mesh.points, dtype=np.float64)
    cells = np.asarray(mesh.cells, dtype=np.int64)
    nc = cells.shape[0]

    def data_arrays(data, indent):
        out = []
        for name, arr in data.items():
            arr = _pad3(arr)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            out.append(
                f'{indent}<DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="binary">'
                f"{_b64(arr)}</DataArray>"
            )
        return "\n".join(out)

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
  <UnstructuredGrid>
    <Piece NumberOfPoints="{mesh.num_vertices}" NumberOfCells="{nc}">
      <Points>
        <DataArray type="Float64" NumberOfComponents="3" format="binary">{_b64(pts)}</DataArray>
      </Points>
      <Cells>
        <DataArray type="Int64" Name="connectivity" format="binary">{_b64(cells.reshape(-1))}</DataArray>
        <DataArray type="Int64" Name="offsets" format="binary">{_b64(3 * np.arange(1, nc + 1, dtype=np.int64))}</DataArray>
        <DataArray type="UInt8" Name="types" format="binary">{_b64(np.full(nc, 5, dtype=np.uint8))}</DataArray>
      </Cells>
      <PointData>
{data_arrays(point_data, "        ")}
      </PointData>
      <CellData>
{data_arrays(cell_data, "        ")}
      </CellData>
    </Piece>
  </UnstructuredGrid>
</VTKFile>
"""
    with open(path, "w") as f:
        f.write(xml)
    return path


def write_xdmf(path, mesh, point_data=None, cell_data=None) -> str:
    """Write an XDMF file (+ sibling .h5 when h5py is available, else inline
    XML data) — the reference's deliverable format for ParaView."""
    point_data = {name: _host(a) for name, a in (point_data or {}).items()}
    cell_data = {name: _host(a) for name, a in (cell_data or {}).items()}
    pts = np.asarray(mesh.points, dtype=np.float64)
    cells = np.asarray(mesh.cells, dtype=np.int64)
    nc = cells.shape[0]

    try:
        import h5py
    except ImportError:
        h5py = None

    items = {}
    if h5py is not None:
        h5path = os.path.splitext(path)[0] + ".h5"
        h5name = os.path.basename(h5path)
        with h5py.File(h5path, "w") as h5:
            h5["/mesh/points"] = pts
            h5["/mesh/cells"] = cells
            for name, arr in point_data.items():
                h5["/point/" + name] = np.asarray(arr, dtype=np.float64)
            for name, arr in cell_data.items():
                h5["/cell/" + name] = np.asarray(arr, dtype=np.float64)

        def item(arr, key):
            dims = " ".join(str(d) for d in arr.shape)
            num = "Int" if arr.dtype.kind == "i" else "Float"
            prec = arr.dtype.itemsize
            return (
                f'<DataItem Dimensions="{dims}" NumberType="{num}" '
                f'Precision="{prec}" Format="HDF">{h5name}:{key}</DataItem>'
            )

        items["points"] = item(pts, "/mesh/points")
        items["cells"] = item(cells, "/mesh/cells")
        for name, arr in point_data.items():
            items["p_" + name] = item(
                np.asarray(arr, dtype=np.float64), "/point/" + name
            )
        for name, arr in cell_data.items():
            items["c_" + name] = item(
                np.asarray(arr, dtype=np.float64), "/cell/" + name
            )
    else:
        def item(arr, _key=None):
            arr = np.asarray(arr)
            dims = " ".join(str(d) for d in arr.shape)
            num = "Int" if arr.dtype.kind == "i" else "Float"
            plain = int if num == "Int" else float
            body = "\n".join(
                " ".join(repr(plain(x)) for x in np.atleast_1d(row))
                for row in (arr if arr.ndim > 1 else arr[:, None])
            )
            return (
                f'<DataItem Dimensions="{dims}" NumberType="{num}" '
                f'Format="XML">\n{body}\n</DataItem>'
            )

        items["points"] = item(pts)
        items["cells"] = item(cells)
        for name, arr in point_data.items():
            items["p_" + name] = item(np.asarray(arr, dtype=np.float64))
        for name, arr in cell_data.items():
            items["c_" + name] = item(np.asarray(arr, dtype=np.float64))

    def attr(name, arr, center, it):
        atype = "Scalar" if np.asarray(arr).ndim == 1 else "Vector"
        return (
            f'<Attribute Name="{name}" AttributeType="{atype}" '
            f'Center="{center}">\n{it}\n</Attribute>'
        )

    attrs = []
    for name, arr in point_data.items():
        attrs.append(attr(name, arr, "Node", items["p_" + name]))
    for name, arr in cell_data.items():
        attrs.append(attr(name, arr, "Cell", items["c_" + name]))

    xml = f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="Triangle" NumberOfElements="{nc}">
        {items['cells']}
      </Topology>
      <Geometry GeometryType="XY">
        {items['points']}
      </Geometry>
      {chr(10).join(attrs)}
    </Grid>
  </Domain>
</Xdmf>
"""
    with open(path, "w") as f:
        f.write(xml)
    return path
