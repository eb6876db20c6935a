"""Function spaces, dofmaps and functions.

Counterpart of the JAX package's ``fem/spaces.py``.  ``FunctionSpace`` is
host-only: its dofmap tables are plain NumPy, copied unchanged.
``Function`` holds a torch dof vector and evaluates it batched over all
cells from reference tabulations and the Piola / affine push-forward.  The
geometry (``J``, ``K``, ``detJ``), the dofmaps and the tabulations a
function needs are uploaded once per (mesh or space, device) and kept
beside the host object (``mesh_geometry``, ``space_tables``,
``tabulation``), so repeated evaluations move no tables.

Four families on triangles:

* ``"P"``    continuous Lagrange of degree k (primal solutions, hat functions)
* ``"DG"``   discontinuous, *orthonormal Dubiner* modal basis of degree k
             (projected fluxes / RHS; mass matrix = |detJ| * I per cell)
* ``"RT"``   H(div)-conforming hierarchic Raviart-Thomas of degree k
             (equilibrated fluxes; facet dofs shared, orientation signs)
* ``"DRT"``  cell-wise (discontinuous) hierarchic RT (SE flux correctors,
             reference ``FluxEqlbSE.py:98-101``)
"""

from __future__ import annotations

import numpy as np
import torch

from ..elements.lagrange import lagrange_cached, dubiner_cached
from ..elements.rt import rt_cached
from ..mesh.topology import TriMesh

__all__ = ["FunctionSpace", "Function", "resolve_device", "mesh_geometry",
           "mesh_space", "space_tables", "dof_owner", "tabulation"]


def resolve_device(device, who: str) -> torch.device:
    """``None`` means the CUDA card; without one, raise rather than fall
    back to the CPU.  Anything else is taken as given, with a bare
    ``"cuda"`` pinned to the current card's index so that it compares
    equal to a tensor's device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on the CUDA card by default and none is "
                "available; pass device='cpu' for the plain versions")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _cached(obj, attr: str, key, build):
    """``build()`` once per key, kept in a dict attribute of ``obj``."""
    store = obj.__dict__.setdefault(attr, {})
    if key not in store:
        store[key] = build()
    return store[key]


def mesh_geometry(mesh: TriMesh, device) -> dict:
    """The affine geometry of every cell, f64 on ``device``: ``J``, ``K``
    (nc, 2, 2) and ``detJ`` (nc,); uploaded once per (mesh, device)."""
    device = torch.device(device)
    return _cached(mesh, "_torch_geometry", str(device), lambda: {
        name: torch.as_tensor(getattr(mesh, name), dtype=torch.float64,
                              device=device)
        for name in ("J", "K", "detJ")})


def mesh_space(mesh: TriMesh, family: str, degree: int,
               vs: int = 1) -> "FunctionSpace":
    """One ``FunctionSpace`` per (mesh, family, degree, vs), kept beside the
    mesh, so that callers who build a space internally (the equilibrators,
    the checks) share its device tables instead of uploading them again."""
    return _cached(mesh, "_torch_spaces", (family, degree, vs),
                   lambda: FunctionSpace(mesh, family, degree, vs=vs))


def space_tables(V: "FunctionSpace", device) -> dict:
    """The dofmap on ``device``: ``cell_dofs`` (nc, nd) int64 and
    ``dof_signs`` (nc, nd) f64 or None; uploaded once per (space, device)."""
    device = torch.device(device)

    def build():
        sg = V.dof_signs
        return {
            "cell_dofs": torch.as_tensor(V.cell_dofs.astype(np.int64),
                                         device=device),
            "dof_signs": None if sg is None else torch.as_tensor(
                sg, dtype=torch.float64, device=device)}

    return _cached(V, "_torch_tables", str(device), build)


def dof_owner(V: "FunctionSpace", device) -> torch.Tensor:
    """For each scalar dof, the flat position (c * nd + i) of its LAST
    occurrence in ``cell_dofs`` in row-major order, int64 on ``device``.

    A per-cell value table scattered into a shared-dof vector by
    ``x.at[cell_dofs].set(v)`` keeps, on JAX's CPU backend, the last
    writer; gathering through this table reproduces that choice exactly,
    where a torch scatter with duplicate indices leaves it undefined."""
    device = torch.device(device)

    def build():
        flat = V.cell_dofs.astype(np.int64).ravel()
        order = np.argsort(flat, kind="stable")
        sf = flat[order]
        last = np.append(sf[1:] != sf[:-1], True)
        owner = np.full(V.ndofs_scalar, -1, dtype=np.int64)
        owner[sf[last]] = order[last]
        if (owner < 0).any():
            raise ValueError("a dof of the space belongs to no cell")
        return torch.as_tensor(owner, device=device)

    return _cached(V, "_torch_owner", str(device), build)


def tabulation(V: "FunctionSpace", pts: np.ndarray, device,
               kind: str = "values") -> torch.Tensor:
    """The element's reference tabulation at ``pts`` as f64 on ``device``:
    ``"values"`` (nd, nq) or (nd, 2, nq) for RT, ``"div"`` (nd, nq),
    ``"grad"`` (nd, 2, nq); uploaded once per (space, points, kind,
    device)."""
    device = torch.device(device)
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    key = (kind, pts.shape, pts.tobytes(), str(device))

    def build():
        if kind == "values":
            tab = V.tabulate(pts)
        elif kind == "div":
            tab = V.element.tabulate_div(pts)
        elif kind == "grad":
            tab = V.element.tabulate_grad(pts)
        else:
            raise ValueError(f"unknown tabulation {kind!r}")
        return torch.as_tensor(tab, dtype=torch.float64, device=device)

    return _cached(V, "_torch_tabs", key, build)


class FunctionSpace:
    def __init__(self, mesh: TriMesh, family: str, degree: int, vs: int = 1):
        self.mesh = mesh
        self.family = family
        self.degree = degree
        nc = mesh.num_cells

        if family == "P":
            if degree < 1:
                raise ValueError("P degree >= 1")
            el = self.element = lagrange_cached(degree)
            k = degree
            nv, nf = mesh.num_vertices, mesh.num_facets
            n_edge = k - 1
            n_int = el.ndofs_cell
            self.ndofs_scalar = nv + nf * n_edge + nc * n_int
            cd = np.empty((nc, el.ndofs), dtype=np.int64)
            cd[:, :3] = mesh.cells
            for e in range(3):
                f = mesh.cell_facets[:, e].astype(np.int64)
                aligned = mesh.edge_aligned[:, e]
                for i in range(n_edge):
                    # element node order runs along the local edge direction;
                    # reverse the block when anti-aligned with the canonical
                    # (ascending-global-id) facet direction
                    ii = np.where(aligned, i, n_edge - 1 - i)
                    cd[:, 3 + e * n_edge + i] = nv + f * n_edge + ii
            base = nv + nf * n_edge
            for j in range(n_int):
                cd[:, 3 + 3 * n_edge + j] = base + np.arange(nc) * n_int + j
            self.cell_dofs = cd.astype(np.int32)
            self.dof_signs = None
            self.vs = vs
        elif family == "DG":
            el = self.element = dubiner_cached(degree)
            nd = el.ndofs
            self.ndofs_scalar = nc * nd
            self.cell_dofs = (
                np.arange(nc, dtype=np.int64)[:, None] * nd
                + np.arange(nd)[None, :]
            ).astype(np.int32)
            self.dof_signs = None
            self.vs = vs
        elif family == "RT":
            el = self.element = rt_cached(degree)
            if vs != 1:
                raise ValueError("RT is intrinsically vector-valued")
            k = degree
            nf = mesh.num_facets
            kk1 = el.ndofs_cell
            self.ndofs_scalar = nf * k + nc * kk1
            cd = np.empty((nc, el.ndofs), dtype=np.int64)
            sg = np.ones((nc, el.ndofs))
            for e in range(3):
                f = mesh.cell_facets[:, e].astype(np.int64)
                aligned = mesh.edge_aligned[:, e]
                for m in range(k):
                    cd[:, e * k + m] = f * k + m
                    # facet reversal: s -> 1-s and normal flip give the
                    # diagonal sign (-1)^(m+1) (cf. the reference's binomial
                    # transformation se/KernelData.cpp:46-64 for monomials)
                    sg[:, e * k + m] = np.where(aligned, 1.0, (-1.0) ** (m + 1))
            for j in range(kk1):
                cd[:, 3 * k + j] = nf * k + np.arange(nc) * kk1 + j
            self.cell_dofs = cd.astype(np.int32)
            self.dof_signs = sg
            self.vs = 2  # physical value shape
        elif family == "DRT":
            el = self.element = rt_cached(degree)
            nd = el.ndofs
            self.ndofs_scalar = nc * nd
            self.cell_dofs = (
                np.arange(nc, dtype=np.int64)[:, None] * nd
                + np.arange(nd)[None, :]
            ).astype(np.int32)
            self.dof_signs = None
            self.vs = 2
        else:
            raise ValueError(f"unknown family {family}")

        if family in ("P", "DG"):
            self.block_size = vs
        else:
            self.block_size = 1
        self.ndofs = self.ndofs_scalar * self.block_size

    # --- tabulation cache (host NumPy) --------------------------------------

    def tabulate(self, pts: np.ndarray) -> np.ndarray:
        """The element's tabulation at reference points, once per point set.
        Kept on the space (not in a module-level cache, which would hold
        the space, its mesh and their device tables alive across the meshes
        of an adaptive loop)."""
        pts = np.ascontiguousarray(pts, dtype=np.float64)
        return _cached(self, "_host_tabs", (pts.shape, pts.tobytes()),
                       lambda: self.element.tabulate(pts))

    def new_function(self, device=None) -> "Function":
        return Function(self, device=device)


def _as_pts(pts) -> np.ndarray:
    pts = np.asarray(pts, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError("reference points must be (nq, 2)")
    return pts


class Function:
    """FE function: dof vector ``x`` (1-D tensor) over a FunctionSpace.

    dof layout: scalar spaces — plain; vector P/DG (block_size b) —
    component-major blocks ``x[comp * ndofs_scalar + scalar_dof]``.

    ``x``: a tensor keeps its device (``device`` moves it); host data (a
    copy) or none (f64 zeros) goes to ``device``, the CUDA card by default
    — pass ``device="cpu"`` for the CPU."""

    def __init__(self, space: FunctionSpace, x=None, device=None):
        self.space = space
        if isinstance(x, torch.Tensor):
            self.x = x if device is None else x.to(device)
            return
        device = resolve_device(device, "Function")
        if x is None:
            self.x = torch.zeros(space.ndofs, dtype=torch.float64,
                                 device=device)
        else:
            self.x = torch.tensor(np.asarray(x), device=device)

    @property
    def device(self) -> torch.device:
        return self.x.device

    # --- expression protocol -------------------------------------------------
    @property
    def value_size(self) -> int:
        s = self.space
        return s.vs if s.family in ("RT", "DRT") else s.block_size

    def _blocks(self, cell_dofs):
        """Per-cell dof values of every component -> list of (nc, nd)."""
        s = self.space
        xs = self.x.reshape(s.block_size, s.ndofs_scalar)
        return [xs[b][cell_dofs] for b in range(s.block_size)]

    def evaluate(self, qpoints_ref: np.ndarray) -> torch.Tensor:
        """Values at reference points in every cell -> (nc, nq, vs)."""
        s = self.space
        pts = _as_pts(qpoints_ref)
        dev = self.x.device
        t = space_tables(s, dev)
        tab = tabulation(s, pts, dev).to(self.x.dtype)
        if s.family in ("P", "DG"):
            # (nd, nq)
            return torch.stack([torch.einsum("cd,dq->cq", xb, tab)
                                for xb in self._blocks(t["cell_dofs"])],
                               dim=-1)
        # RT / DRT: contravariant Piola; tab (nd, 2, nq)
        gath = self.x[t["cell_dofs"]]
        if t["dof_signs"] is not None:
            gath = gath * t["dof_signs"]
        ref = torch.einsum("cd,daq->cqa", gath, tab)
        geo = mesh_geometry(s.mesh, dev)
        return (torch.einsum("cab,cqb->cqa", geo["J"], ref)
                / geo["detJ"][:, None, None])

    def evaluate_div(self, qpoints_ref: np.ndarray) -> torch.Tensor:
        """Divergence at reference points (RT/DRT only) -> (nc, nq, 1)."""
        s = self.space
        if s.family not in ("RT", "DRT"):
            raise ValueError(f"evaluate_div needs an RT/DRT space, not "
                             f"{s.family}")
        pts = _as_pts(qpoints_ref)
        dev = self.x.device
        t = space_tables(s, dev)
        tab = tabulation(s, pts, dev, "div").to(self.x.dtype)  # (nd, nq)
        gath = self.x[t["cell_dofs"]]
        if t["dof_signs"] is not None:
            gath = gath * t["dof_signs"]
        ref = torch.einsum("cd,dq->cq", gath, tab)
        det = mesh_geometry(s.mesh, dev)["detJ"]
        return (ref / det[:, None])[..., None]

    def evaluate_grad(self, qpoints_ref: np.ndarray) -> torch.Tensor:
        """Gradient (P/DG) -> (nc, nq, vs, 2): grad = K^T grad_ref."""
        s = self.space
        if s.family not in ("P", "DG"):
            raise ValueError(f"evaluate_grad needs a P/DG space, not "
                             f"{s.family}")
        pts = _as_pts(qpoints_ref)
        dev = self.x.device
        t = space_tables(s, dev)
        # (nd, 2, nq) reference gradients
        tabg = tabulation(s, pts, dev, "grad").to(self.x.dtype)
        K = mesh_geometry(s.mesh, dev)["K"]
        out = []
        for xb in self._blocks(t["cell_dofs"]):
            g = torch.einsum("cd,dbq->cqb", xb, tabg)
            out.append(torch.einsum("cba,cqb->cqa", K, g))
        return torch.stack(out, dim=-2)

    def copy(self) -> "Function":
        return Function(self.space, self.x.clone())
