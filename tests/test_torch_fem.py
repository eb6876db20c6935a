"""The port's ``fem`` layer against the JAX package's: ``Function``
evaluation (values, div, grad) on P / DG / RT / DRT, every
``local_projection`` family, ``interpolate`` into P / RT / DRT,
``project_facet_trace``, the assembly functions, expression arithmetic and
``permute_vertices``.  Same seeded NumPy inputs into both packages, f64,
within 1e-11 * max(1, max|x|).

The meshes are ``unit_square(3)`` and its ``permute_vertices`` renumbering
(reversed edges, negative Jacobians): there a P-space projection's per-cell
values at a shared dof differ, and the JAX package keeps the last cell's
value in row-major order, which the port reproduces."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.mesh import generators as jgen

from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.elements.quadrature import gauss_triangle
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen

torch.set_num_threads(2)

_MESHES = {
    "crossed": lambda g: g.unit_square(3),
    "permuted": lambda g: g.permute_vertices(g.unit_square(3), seed=13),
}

# (family, degree, vs)
_SPACES = [("P", 1, 1), ("P", 2, 1), ("P", 2, 2), ("DG", 0, 1), ("DG", 1, 1),
           ("DG", 2, 2), ("RT", 1, 1), ("RT", 2, 1), ("RT", 3, 1),
           ("DRT", 2, 1)]

_PTS = np.array([[0.2, 0.3], [0.6, 0.1], [1 / 3, 1 / 3], [0.05, 0.9]])


def _sid(s):
    return f"{s[0]}{s[1]}" + ("v" if s[2] == 2 else "")


@pytest.fixture(scope="module", params=sorted(_MESHES))
def meshes(request):
    make = _MESHES[request.param]
    return make(jgen), make(tgen)


def _spaces(meshes, family, degree, vs=1):
    jm, tm = meshes
    return (jfem.FunctionSpace(jm, family, degree, vs=vs),
            tfem.FunctionSpace(tm, family, degree, vs=vs))


def _close(a_port, a_jax, rel=1e-11):
    a_port = a_port.numpy() if isinstance(a_port, torch.Tensor) else a_port
    a_jax = np.asarray(a_jax)
    assert a_port.shape == a_jax.shape
    assert np.isfinite(a_port).all()
    tol = rel * max(1.0, float(np.abs(a_jax).max()))
    assert np.abs(a_port - a_jax).max() <= tol


def _u(x):
    return np.sin(2 * np.pi * x[..., 0]) * np.cos(3 * x[..., 1]) + x[..., 0]


def _vec(x):
    return np.stack([np.exp(x[..., 0]) * x[..., 1],
                     np.cos(2 * x[..., 0] + x[..., 1])], axis=-1)


def _functions(meshes, family, degree, vs, seed=0):
    jV, tV = _spaces(meshes, family, degree, vs)
    x = np.random.default_rng(seed).normal(size=jV.ndofs)
    return jfem.Function(jV, x), tfem.Function(tV, x, device="cpu")


def test_permute_vertices_identical():
    for seed in (0, 7, 13):
        jm = jgen.permute_vertices(jgen.unit_square(3), seed=seed)
        tm = tgen.permute_vertices(tgen.unit_square(3), seed=seed)
        for attr in ("points", "cells", "facet_vertices", "cell_facets",
                     "facet_cells", "facet_local", "edge_aligned", "J",
                     "detJ", "K", "boundary_outward_sign"):
            a, b = getattr(jm, attr), getattr(tm, attr)
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(a, b, err_msg=attr)
        assert (tm.detJ < 0).any() and (~tm.edge_aligned).any()


@pytest.mark.parametrize("space", _SPACES, ids=_sid)
def test_function_evaluate(meshes, space):
    jf, tf = _functions(meshes, *space, seed=1)
    assert tf.value_size == jf.value_size
    assert tf.x.dtype == torch.float64 and tf.device.type == "cpu"
    _close(tf.evaluate(_PTS), jf.evaluate(_PTS))
    if space[0] in ("RT", "DRT"):
        _close(tf.evaluate_div(_PTS), jf.evaluate_div(_PTS))
    else:
        _close(tf.evaluate_grad(_PTS), jf.evaluate_grad(_PTS))
    cp = tf.copy()
    assert cp.x is not tf.x and torch.equal(cp.x, tf.x)


def test_function_defaults(meshes):
    _, tV = _spaces(meshes, "RT", 2)
    f = tfem.Function(tV, device="cpu")
    assert f.x.dtype == torch.float64 and f.x.shape == (tV.ndofs,)
    assert not f.x.any()
    x = torch.arange(tV.ndofs, dtype=torch.float64)
    assert tfem.Function(tV, x).x is x  # a tensor keeps its device


@pytest.mark.parametrize("space", [("DG", 0, 1), ("DG", 1, 1), ("DG", 2, 2),
                                   ("RT", 1, 1), ("RT", 2, 1), ("DRT", 2, 1),
                                   ("P", 1, 1), ("P", 2, 1), ("P", 2, 2)],
                         ids=_sid)
def test_local_projection(meshes, space):
    family, degree, vs = space
    jV, tV = _spaces(meshes, family, degree, vs)
    jm, tm = meshes
    if vs == 2 or family in ("RT", "DRT"):
        jd = [jfem.expr_from_callable(_vec, jm, 2)]
        td = [tfem.expr_from_callable(_vec, tm, 2)]
    else:
        jd, td = [_u, lambda x: x[..., 0] * x[..., 1]], [
            _u, lambda x: x[..., 0] * x[..., 1]]
    jout = jfem.local_projection(jV, jd, quadrature_degree=8)
    tout = tfem.local_projection(tV, td, quadrature_degree=8, device="cpu")
    assert len(tout) == len(jout)
    for tf, jf in zip(tout, jout):
        _close(tf.x, jf.x)


def test_p_projection_last_writer(meshes):
    """Shared P dofs: the per-cell solutions disagree, and the port keeps
    the JAX package's last writer (row-major cell order) — the first
    writer would be off by the spread."""
    jV, tV = _spaces(meshes, "P", 1)
    pts, w = gauss_triangle(2 * 1 + 2)  # local_projection's default
    tab = jV.tabulate(pts)
    vals = _u(tV.mesh.map_points(pts))
    M = np.einsum("q,iq,jq->ij", w, tab, tab)
    sol = np.linalg.solve(M, np.einsum("q,cq,iq->ci", w, vals, tab).T).T
    first = np.full(tV.ndofs, np.nan)
    for c in reversed(range(tV.mesh.num_cells)):
        first[tV.cell_dofs[c]] = sol[c]
    (jf,), (tf,) = (jfem.local_projection(jV, [_u]),
                    tfem.local_projection(tV, [_u], device="cpu"))
    _close(tf.x, jf.x)
    assert np.abs(tf.x.numpy() - first).max() > 1e-3


@pytest.mark.parametrize("space", [("P", 2, 1), ("P", 3, 2), ("RT", 1, 1),
                                   ("RT", 2, 1), ("RT", 3, 1), ("DRT", 2, 1)],
                         ids=_sid)
def test_interpolate(meshes, space):
    family, degree, vs = space
    jV, tV = _spaces(meshes, family, degree, vs)
    jm, tm = meshes
    if family == "P" and vs == 1:
        jd, td = _u, _u
    elif family == "P":
        jd = jfem.expr_from_callable(_vec, jm, 2)
        td = tfem.expr_from_callable(_vec, tm, 2)
    else:
        # a vector DG function: div and interior moments from its grads
        jd, td = _functions(meshes, "DG", degree, 2, seed=3)
    jf = jfem.interpolate(jV, jd)
    tf = tfem.interpolate(tV, td, device="cpu")
    _close(tf.x, jf.x)


def test_project_facet_trace(meshes):
    jm, tm = meshes
    facets = tm.boundary_facets[::2]
    for degree in (1, 2, 3):
        _close(tfem.project_facet_trace(tm, facets, _u, degree),
               jfem.project_facet_trace(jm, facets, _u, degree), rel=0)


def test_assemble(meshes):
    jf, tf = _functions(meshes, "DG", 2, 1, seed=4)
    jv, tv = _functions(meshes, "RT", 2, 1, seed=5)
    _close(tfem.cell_integrals(tf, 4), jfem.cell_integrals(jf, 4))
    _close(tfem.cell_integrals_sq(tv, 6), jfem.cell_integrals_sq(jv, 6))
    _close(tfem.assemble_scalar(tf, 4), jfem.assemble_scalar(jf, 4))
    jm, tm = meshes
    _close(tfem.assemble_scalar(tfem.as_expr(_u, tm), 8, device="cpu"),
           jfem.assemble_scalar(jfem.as_expr(_u, jm), 8))


def _expr_cases(pkg, m, fs):
    """The expression surface on one package: f scalar DG, g scalar P,
    v vector DG, r RT; returns {name: expr}."""
    f, g, v, r = fs
    fn = pkg.expr_from_callable(_u, m)
    vn = pkg.expr_from_callable(_vec, m, 2)
    cells = np.linspace(0.5, 2.0, m.num_cells)
    return {
        "sum": pkg.as_expr(f) + g,
        "sub_callable": f - fn,
        "rsub": _u - pkg.as_expr(g),
        "scale_neg": -(2.5 * pkg.as_expr(v)) + vn,
        "prod": pkg.as_expr(f) * v,
        "prod_callable": fn * pkg.as_expr(r),
        "grad": pkg.grad(g) + pkg.grad(f),
        "div": pkg.div(r) * f,
        "comp": pkg.comp(pkg.as_expr(r) - v, 1),
        "vector": pkg.as_vector([f, fn]),
        "cell_scale": pkg.cell_scale(pkg.as_expr(v) + vn, cells),
    }


def test_expression_arithmetic(meshes):
    jfs, tfs = zip(*(_functions(meshes, fam, deg, vs, seed=10 + i)
                     for i, (fam, deg, vs) in enumerate(
                         [("DG", 2, 1), ("P", 2, 1), ("DG", 1, 2),
                          ("RT", 2, 1)])))
    jm, tm = meshes
    jx, tx = _expr_cases(jfem, jm, jfs), _expr_cases(tfem, tm, tfs)
    for name in jx:
        assert tx[name].value_size == jx[name].value_size, name
        _close(tx[name].evaluate(_PTS), jx[name].evaluate(_PTS))
    # divergence through sums, scales and cell scaling; vector DG by grads
    cells = np.linspace(0.5, 2.0, tm.num_cells)
    for pkg, fs, out in ((jfem, jfs, jx), (tfem, tfs, tx)):
        out["div_sum"] = -(2.5 * pkg.as_expr(fs[2])) + fs[3]
        out["div_cells"] = pkg.cell_scale(pkg.as_expr(fs[3]) - fs[2], cells)
    for name in ("div_sum", "div_cells"):
        _close(tx[name].evaluate_div(_PTS), jx[name].evaluate_div(_PTS))
