"""The system under test: ``dolfinx_eqlb_tpu_torch``'s equilibration engine
on the benchmark's mesh, set up and called as ``FluxEquilibrator._solve``
calls it.

One field, batch-major data resident on the device, ``BoundaryData``'s
facet kinds and facet values as its host arrays (the engine uploads them
on every call, as it does for ``_solve``), no ``transposed_inputs``.
The benchmark takes from the program only this call, its set-up, its
counters and its mesh's facet table (the index map of the returned dof
vectors).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dolfinx_eqlb_tpu_torch.eqlb.bcs import BoundaryData
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import TriMesh

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The engine of one configuration on ``device``.  ``dtype`` overrides
    the configuration's precision (the control runs the f32 engine)."""

    def __init__(self, config: dict, points: np.ndarray, cells: np.ndarray,
                 device: torch.device, dtype: torch.dtype | None = None):
        k = config["degree"]
        self.device = device
        self.dtype = dtype or DTYPES[config["dtype"]]
        if config["boundary"] != "primal_dirichlet":
            raise ValueError(f"boundary {config['boundary']!r}: only "
                             "'primal_dirichlet' is drawn by the benchmark")
        t0 = time.perf_counter()
        self.mesh = TriMesh(points, cells)
        buckets = build_patches(self.mesh)
        self.engine = EqlbEngine(
            FunctionSpace(self.mesh, "RT", k), buckets, dtype=self.dtype,
            device=device,
            max_patches_per_bucket=config["max_patches_per_bucket"])
        self.engine.mode = config["mode"]
        self.engine.solver = config["solver"]
        self.bd = BoundaryData(self.mesh, k, 1)
        self.host_tables_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.engine.mode == "kkt":
            self.engine._kkt_tables()
        else:
            self.engine._device_tables()
        sync(device)
        self.geometry_caches_s = time.perf_counter() - t0

    def __call__(self, d_proj: torch.Tensor, d_rhs: torch.Tensor) -> torch.Tensor:
        """One equilibration: d_proj (1, nc, 2, ndg), d_rhs (1, nc, ndg) on
        the device -> the global RT dof vector (1, ndofs)."""
        return self.engine.equilibrate(d_proj, d_rhs, self.bd.facet_kind,
                                       self.bd.bvals)

    def facet_vertices(self) -> np.ndarray:
        return self.mesh.facet_vertices
