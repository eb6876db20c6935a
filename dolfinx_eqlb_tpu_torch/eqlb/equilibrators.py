"""User-facing flux equilibrators: FluxEqlbEV and FluxEqlbSE.

Port of the JAX package's ``eqlb/equilibrators.py`` (API mirror of the
reference's ``python/dolfinx_eqlb/eqlb/FluxEqlbEV.py`` / ``FluxEqlbSE.py``):
construct with (degree, mesh, projected RHS, projected fluxes), call
``set_boundary_conditions`` then ``equilibrate_fluxes``.

Both strategies produce the unique patch-wise minimiser (see
``eqlb.engine``); they differ in the returned representation:
  * EV returns the equilibrated flux itself in the conforming RT space
    (reference ``FluxEqlbEV.py:178-188``)
  * SE returns the *corrector* in a discontinuous RT space: reconstructed
    flux = corrector + projected flux (reference ``FluxEqlbSE.py:176-186``)

The engine runs on the device of the projected Functions (or ``device``)
in f64, and its inputs stay there.  ``FluxEqlbSE(equilibrate_stress=True)``
equilibrates the first two fluxes as the rows of a weakly symmetric stress
(``eqlb.stress``; deficient pure-traction corner patches at degree 2 are
grouped, ``eqlb.grouping``), and ``estimate_korn_constant=True`` adds the
cell Korn constants (``eqlb.korn``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.spaces import Function, mesh_space, space_tables
from ..fem.interpolate import interpolate
from .bcs import BoundaryData, boundarydata, boundary_function
from .engine import EqlbEngine
from .patches import build_patches

__all__ = ["FluxEquilibrator", "FluxEqlbEV", "FluxEqlbSE"]

def _mesh_patches(mesh):
    """The mesh's vertex patches, built once per mesh."""
    if not hasattr(mesh, "_torch_patches"):
        mesh._torch_patches = build_patches(mesh)
    return mesh._torch_patches


def _dg_dofs(f: Function, ndg: int) -> torch.Tensor:
    """Dubiner dofs of a (vector) DG function, zero-padded to ndg modes
    (the Dubiner basis is hierarchic, so lower-degree data embeds exactly)
    -> (nc, vs, ndg) on the function's device."""
    V = f.space
    if V.family != "DG":
        raise ValueError("projected data must be DG functions")
    nd = V.element.ndofs
    nc = V.mesh.num_cells
    x = f.x.reshape(V.block_size, nc, nd)
    if nd < ndg:
        x = torch.nn.functional.pad(x, (0, ndg - nd))
    elif nd > ndg:
        raise ValueError("projected data degree exceeds flux degree - 1")
    return x.movedim(0, 1)


class FluxEquilibrator:
    """Base: shared setup of the patch tables and the batched engine
    (reference ``eqlb/FluxEquilibrator.py``)."""

    def __init__(self, degree_flux: int, msh, list_rhs, list_proj_flux,
                 pad_quantize: float | None = None, device=None):
        """``pad_quantize`` is accepted for parity with the reference and
        ignored (see ``EqlbEngine``).  ``device``: where the engine runs;
        by default the device of the projected fluxes."""
        if len(list_rhs) != len(list_proj_flux):
            raise RuntimeError("Mismatching inputs!")
        self.degree_flux = degree_flux
        self.mesh = msh
        self.n_fluxes = len(list_rhs)
        k = degree_flux
        ndg = k * (k + 1) // 2
        for f in list_proj_flux:
            if f.space.family != "DG" or f.space.block_size != 2:
                raise ValueError("projected fluxes must be vector DG functions")
        for f in list_rhs:
            if f.space.family != "DG" or f.space.block_size != 1:
                raise ValueError("projected RHS must be scalar DG functions")
        device = torch.device(device) if device is not None else (
            list_proj_flux[0].device)
        self._V_rt = mesh_space(msh, "RT", k)
        self.engine = EqlbEngine(self._V_rt, _mesh_patches(msh),
                                 dtype=torch.float64, device=device,
                                 pad_quantize=pad_quantize)
        self._d_proj = torch.stack([
            _dg_dofs(f, ndg).to(device, torch.float64)
            for f in list_proj_flux])  # (n_rhs, nc, 2, ndg)
        self._d_rhs = torch.stack([
            _dg_dofs(f, ndg)[:, 0].to(device, torch.float64)
            for f in list_rhs])  # (n_rhs, nc, ndg)
        self.list_proj_flux = list_proj_flux
        self.list_rhs = list_rhs
        self.boundary_data: BoundaryData | None = None
        self.list_flux: list[Function] = []
        self.list_bfunctions: list[Function] = []

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def set_boundary_conditions(self, list_bfct_prime, list_bcs_flux, quadrature_degree=None):
        if self.n_fluxes != len(list_bfct_prime) or self.n_fluxes != len(list_bcs_flux):
            raise RuntimeError("Mismatching inputs!")
        self.boundary_data = boundarydata(
            list_bcs_flux, self._V_rt, list_bfct_prime, quadrature_degree
        )
        self.list_bfunctions = [
            boundary_function(self.boundary_data, i, self._V_rt, self.device)
            for i in range(self.n_fluxes)
        ]

    def _solve(self, weak_symmetry=False, ws_skip_nodes=None):
        if self.boundary_data is None:
            # no BCs set: all boundary facets flux-free
            self.boundary_data = BoundaryData(
                self.mesh, self.degree_flux, self.n_fluxes
            )
        bd = self.boundary_data
        return self.engine.equilibrate(
            self._d_proj, self._d_rhs, bd.facet_kind, bd.bvals,
            weak_symmetry=weak_symmetry, ws_skip_nodes=ws_skip_nodes,
        )  # (n_rhs, ndofs_rt)

    def get_reconstructed_fluxes(self, subproblem: int):
        return self.list_flux[subproblem]


class FluxEqlbEV(FluxEquilibrator):
    """Constrained-minimisation equilibrator (Ern & Vohralik 2015), reference
    ``FluxEqlbEV.py``.  Result: the flux itself, conforming RT."""

    def __init__(self, degree_flux, msh, list_rhs, list_proj_flux,
                 pad_quantize=None, device=None):
        super().__init__(degree_flux, msh, list_rhs, list_proj_flux,
                         pad_quantize=pad_quantize, device=device)
        self.V_flux = self._V_rt

    def equilibrate_fluxes(self):
        x = self._solve()
        self.list_flux = [
            Function(self.V_flux, x[i]) for i in range(self.n_fluxes)
        ]


class FluxEqlbSE(FluxEquilibrator):
    """Semi-explicit equilibrator (Bertrand et al. 2023), reference
    ``FluxEqlbSE.py``.  Result: the corrector in discontinuous RT, so the
    reconstructed flux is ``corrector + projected flux``.

    ``equilibrate_stress``: fluxes 0 and 1 are the rows of a stress, made
    weakly symmetric (flux degree >= 2).  ``estimate_korn_constant``: also
    estimate the cell Korn constants (``get_korn_constants``)."""

    def __init__(
        self,
        degree_flux,
        msh,
        list_rhs,
        list_proj_flux,
        equilibrate_stress: bool = False,
        estimate_korn_constant: bool = False,
        pad_quantize: float | None = None,
        device=None,
    ):
        super().__init__(degree_flux, msh, list_rhs, list_proj_flux,
                         pad_quantize=pad_quantize, device=device)
        self.V_flux = mesh_space(msh, "DRT", degree_flux)
        self.equilibrate_stress = equilibrate_stress
        self.estimate_korn_constant = estimate_korn_constant
        self.korn_constants = None
        if equilibrate_stress and self.n_fluxes < 2:
            raise ValueError("stress equilibration needs gdim flux rows")

    def _to_corrector(self, x_rt) -> Function:
        """DRT dofs of a conforming RT dof vector: reference functionals are
        sign * global dofs per cell."""
        t_rt = space_tables(self._V_rt, x_rt.device)
        t_d = space_tables(self.V_flux, x_rt.device)
        gath = x_rt[t_rt["cell_dofs"]] * t_rt["dof_signs"]
        x = x_rt.new_zeros(self.V_flux.ndofs)
        x[t_d["cell_dofs"]] = gath  # cell-wise dofs: unique indices
        return Function(self.V_flux, x)

    def equilibrate_fluxes(self):
        if self.equilibrate_stress and self.degree_flux < 2:
            # reference se/reconstruction.hpp:357-388 enforces the same
            raise ValueError("stress equilibration requires flux degree >= 2")
        groups, skip = [], None
        if (self.equilibrate_stress and self.degree_flux == 2
                and self.boundary_data is not None):
            # deficient pure-traction boundary patches are merged with an
            # adjacent interior patch and corrected jointly (reference
            # se/reconstruction.hpp:166-234 patch grouping); only truly
            # ungroupable meshes raise (eqlb.grouping.build_groups)
            from .grouping import build_groups

            groups, skip = build_groups(
                self.engine, np.asarray(self.boundary_data.facet_kind[:2]))
        x = self._solve(weak_symmetry=self.equilibrate_stress,
                        ws_skip_nodes=skip)
        if groups:
            from .grouping import grouped_weak_symmetry

            x[:2] = grouped_weak_symmetry(
                self.engine, x[:2], self.boundary_data.facet_kind[:2], groups)
        self.list_flux = []
        for i in range(self.n_fluxes):
            sig_r = self._to_corrector(x[i])
            proj_d = interpolate(self.V_flux, self.list_proj_flux[i],
                                 device=x.device)
            self.list_flux.append(
                Function(self.V_flux, sig_r.x - proj_d.x)
            )
        if self.estimate_korn_constant:
            from .korn import estimate_korn_constants

            self.korn_constants = estimate_korn_constants(
                self.mesh, device=self.device)

    def get_korn_constants(self):
        if self.korn_constants is None:
            raise RuntimeError("Korn constants are not estimated!")
        return self.korn_constants
