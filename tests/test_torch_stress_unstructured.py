"""The port's weakly symmetric stress equilibration against the JAX
package's on the unstructured mesh of ``tests/test_stress.py``, f64 on the CPU:
``FluxEqlbSE(equilibrate_stress=True, estimate_korn_constant=True)`` on the
exact polynomial stress at k = 2-4, both stress rows within
1e-11 * max(1, max|x|), the Korn constants within 1e-12.  The crossed mesh
is in ``test_torch_stress.py``, the permuted one in
``test_torch_stress_permuted.py``, grouping, the KKT mode and the reduced
formulation in ``test_torch_stress_grouping.py``: each JAX program compiles
once per engine, so the cases are spread over files that run in
parallel."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import eqlb as jeqlb
from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.mesh import generators as jgen

from dolfinx_eqlb_tpu_torch import eqlb as teqlb
from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen

# the KKT-size solves of the port on the CPU stay single-threaded (MKL's
# batched solve stalls with several threads at D >= ~160)
torch.set_num_threads(1)

_PKG = {"jax": (jfem, jeqlb), "torch": (tfem, teqlb)}


def _close(a_port, a_jax, rel):
    a_port = a_port.cpu().numpy() if isinstance(a_port, torch.Tensor) \
        else np.asarray(a_port)
    a_jax = np.asarray(a_jax)
    assert a_port.shape == a_jax.shape
    assert np.isfinite(a_port).all()
    tol = rel * max(1.0, float(np.abs(a_jax).max()))
    assert np.abs(a_port - a_jax).max() <= tol


def _poly(deg):
    """tests/test_stress.py's exact symmetric polynomial stress rows and
    their divergences."""
    d = deg
    rows = (lambda x: np.stack([x[..., 0] ** d + 2 * x[..., 1],
                                x[..., 0] * x[..., 1]], -1),
            lambda x: np.stack([x[..., 0] * x[..., 1],
                                x[..., 1] ** d - x[..., 0]], -1))
    fs = (lambda x: d * x[..., 0] ** (d - 1) + x[..., 0],
          lambda x: x[..., 1] + d * x[..., 1] ** (d - 1))
    return rows, fs, 8


def _flow(pkg, msh, deg, data):
    """Project ``data`` (rows, divergences, quadrature degree) and run
    FluxEqlbSE with stress and Korn constants, every boundary facet
    primal-Dirichlet."""
    fem, eqlb = _PKG[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    rows, fs, qdeg = data
    rhs = fem.local_projection(fem.FunctionSpace(msh, "DG", deg - 1),
                               list(fs), quadrature_degree=qdeg, **kw)
    proj = fem.local_projection(
        fem.FunctionSpace(msh, "DG", deg - 1, vs=2),
        [fem.expr_from_callable(r, msh, value_size=2) for r in rows],
        quadrature_degree=qdeg, **kw)
    eq = eqlb.FluxEqlbSE(deg, msh, rhs, proj, equilibrate_stress=True,
                         estimate_korn_constant=True)
    eq.set_boundary_conditions([msh.boundary_facets] * 2, [[], []])
    eq.equilibrate_fluxes()
    return {"eq": eq, "rhs": rhs, "proj": proj}


_MESHES = {
    "unstructured": lambda g: g.unit_square_unstructured(4, seed=1),
}


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("deg", [2, 3, 4])
def test_stress_matches_jax(mesh, deg):
    out = {pkg: _flow(pkg, _MESHES[mesh](g), deg, _poly(deg))
           for pkg, g in (("jax", jgen), ("torch", tgen))}
    for i in range(2):
        _close(out["torch"]["eq"].list_flux[i].x,
               out["jax"]["eq"].list_flux[i].x, 1e-11)
    _close(out["torch"]["eq"].get_korn_constants().x,
           out["jax"]["eq"].get_korn_constants().x, 1e-12)
