"""The port's KKT mode (``EqlbEngine.mode = "kkt"``: one dense saddle-point
system per patch, solved through K3's plain version on the CPU) against
the JAX engine's KKT mode on the same inputs, within
1e-11 * max(1, max|x|) — the bar of tests/test_combine_paths.py — and
against the port's own semi-explicit mode on compatible data, relative
5e-12 — the bar of tests/test_semiexplicit.py.

Each JAX reference runs once per (mesh, k) with two RHS, random boundary
facet kinds 1/2 and flux data, and padded patch axes (``pad_to_multiple``)
so its host tables carry pad rows for the ``from_host_tables`` case; the
crossed k = 2 reference solves through the Pallas kernel in interpret
mode, the others through ``jnp.linalg.solve``.  The unstructured k = 3 case
holds the systems of K3's wide route (D = 75, 90, 105 and 120): the port
solves D = 120 pivot-free (its own size rule, ``k3_admits``) where JAX's
engine pivots."""

from contextlib import nullcontext

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dolfinx_eqlb_tpu.fem.expressions as ex
from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import Function as JaxFunction
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.fem.projection import local_projection
from dolfinx_eqlb_tpu.mesh import generators as jax_gen

import dolfinx_eqlb_tpu_torch.eqlb.engine as port_engine
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine, k3_admits
from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
    batched_kkt_solve_plain, k3_plan,
)
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import generators as gen

torch.set_num_threads(2)

N_RHS = 2  # the JAX references' batch; n_rhs = 1 cases use its first row

_MESHES = {
    "crossed": lambda g: g.unit_square(3),
    "unstructured": lambda g: g.unit_square_unstructured(4),
    # at RT3 the smallest of these meshes whose patches give every KKT
    # size D = 75, 90, 105 and 120 (K3's wide route on the card; 120 past
    # the reference's size rule, where JAX pivots); the 4 x 4 one gives
    # only 90 and 120
    "unstructured7": lambda g: g.unit_square_unstructured(7),
}
# (mesh, k) -> the JAX reference's solver
_CASES = {
    ("crossed", 1): "xla",
    ("crossed", 2): "pallas",
    ("crossed", 3): "xla",
    ("unstructured", 2): "xla",
    ("unstructured7", 3): "xla",
}


def _data(msh, k, seed):
    """Random DG data; per RHS a random split of the boundary into
    primal-Dirichlet (1) and flux-essential (2) facets, with flux data on
    the essential ones."""
    rng = np.random.default_rng(seed)
    nc, nf, ndg = msh.num_cells, msh.num_facets, k * (k + 1) // 2
    dp = rng.normal(size=(N_RHS, nc, 2, ndg))
    dr = rng.normal(size=(N_RHS, nc, ndg))
    fk = np.zeros((N_RHS, nf), dtype=np.int8)
    bf = msh.boundary_facets
    fk[:, bf] = rng.integers(1, 3, size=(N_RHS, len(bf)))
    bv = np.zeros((N_RHS, nf, k))
    bv[:, bf] = rng.normal(size=(N_RHS, len(bf), k))
    bv[fk != 2] = 0.0
    return dp, dr, fk, bv


@pytest.fixture(scope="module")
def jax_kkt():
    cache = {}

    def get(mesh, k):
        if (mesh, k) not in cache:
            msh = _MESHES[mesh](jax_gen)
            eng = JaxEngine(JaxSpace(msh, "RT", k), jax_patches(msh),
                            pad_to_multiple=8)
            eng.mode = "kkt"
            eng.solver = _CASES[mesh, k]
            data = _data(msh, k, seed=30 + k)
            cache[mesh, k] = eng, data, np.asarray(eng.equilibrate(*data))
        return cache[mesh, k]

    return get


def _port(mesh, k, mode="kkt"):
    msh = _MESHES[mesh](gen)
    eng = EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                     dtype=torch.float64, device="cpu")
    eng.mode = mode
    return eng


def _check(x_port, x_jax):
    assert x_port.shape == x_jax.shape
    assert np.isfinite(x_port).all()
    tol = 1e-11 * max(1.0, np.abs(x_jax).max())
    assert np.abs(x_port - x_jax).max() <= tol


@pytest.mark.parametrize("mesh,k", sorted(_CASES))
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_kkt_matches_jax(jax_kkt, mesh, k, n_rhs):
    _, (dp, dr, fk, bv), x_jax = jax_kkt(mesh, k)
    assert (fk == 2).any() and (fk == 1).any() and (bv != 0).any()
    x = _port(mesh, k).equilibrate(dp[:n_rhs], dr[:n_rhs], fk[:n_rhs],
                                   bv[:n_rhs])
    _check(x.numpy(), x_jax[:n_rhs])


def test_kkt_from_host_tables(jax_kkt):
    """The port's KKT stages on the JAX engine's own host tables, pad rows
    (gdofs == ndofs) included: they are solved and never combined."""
    jeng, data, x_jax = jax_kkt("unstructured", 2)
    assert any(t["gdofs"].shape[0] > b.npatches
               for t, b in ((jeng.tables[key], jeng.buckets[key])
                            for key in jeng.tables))
    eng = EqlbEngine.from_host_tables(
        jeng.V, jeng.buckets, jeng.tables, jeng.se_static, jeng.ref,
        dtype=torch.float64, device="cpu")
    eng.mode = "kkt"
    _check(eng.equilibrate(*data).numpy(), x_jax)


def _compatible_data(msh, k, rng, essential=False):
    """sigma in global RT_{k-1}, projected to vector DG_{k-1}, and
    f = div sigma (tests/test_semiexplicit.py): every hat-function
    compatibility condition holds, so both modes solve the same problem.
    ``essential``: every boundary facet flux-essential with sigma's own
    facet moments as data."""
    nc, nf, ndg = msh.num_cells, msh.num_facets, k * (k + 1) // 2
    fk = np.zeros((N_RHS, nf), dtype=np.int8)
    fk[:, msh.boundary_facets] = 2 if essential else 1
    bv = np.zeros((N_RHS, nf, k))
    if k == 1:
        d_proj = np.zeros((N_RHS, nc, 2, 1))
        d_proj[..., 0] = rng.normal(size=(N_RHS, 1, 2))
        return d_proj, np.zeros((N_RHS, nc, 1)), fk, bv
    Vd = JaxSpace(msh, "RT", k - 1)
    Vdg2 = JaxSpace(msh, "DG", k - 1, vs=2)
    Vdg1 = JaxSpace(msh, "DG", k - 1, vs=1)
    d_proj, d_rhs = [], []
    for r in range(N_RHS):
        x = rng.normal(size=Vd.ndofs)
        sig = JaxFunction(Vd, jnp.asarray(x))
        ps = local_projection(Vdg2, [sig])[0]
        pf = local_projection(Vdg1, [ex.div(sig)])[0]
        d_proj.append(np.asarray(ps.x).reshape(2, nc, ndg).transpose(1, 0, 2))
        d_rhs.append(np.asarray(pf.x).reshape(nc, ndg))
        if essential:  # the facet dofs of sigma are its Legendre moments
            bv[r, :, : k - 1] = x[: nf * (k - 1)].reshape(nf, k - 1)
    return np.stack(d_proj), np.stack(d_rhs), fk, bv


def _modes_agree(k, essential, seed, mesh="crossed"):
    data = _compatible_data(_MESHES[mesh](jax_gen), k,
                            np.random.default_rng(seed), essential)
    eng = _port(mesh, k, mode="semiexplicit")
    x_se = eng.equilibrate(*data)
    eng.mode = "kkt"
    x_kkt = eng.equilibrate(*data)
    return float((x_kkt - x_se).abs().max() / x_kkt.abs().max())


class _OneThread:
    """torch.linalg.solve on the CPU build of torch 2.13 (MKL 2024.2) hangs
    on batched systems of D >= ~156 when it runs on more than one thread:
    every test solve of such systems runs on one."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


@pytest.mark.parametrize("mesh,k", [
    *(pytest.param("crossed", k, id=str(k)) for k in (1, 2, 3, 4)),
    pytest.param("unstructured7", 3, id="unstructured7-3"),
])
def test_kkt_equals_semiexplicit(mesh, k, monkeypatch):
    """K3 takes exactly the systems of the port's size rule
    (``k3_admits``), which is every system of these paths: at k = 4 the
    8-cell patch systems (D = 208) go to K3's cluster route on the card,
    the smaller ones to its register and wide routes.  On the unstructured
    mesh at k = 3 K3 takes D = 75 / 90 / 105 / 120 (its wide route on the
    card), D = 120 past the reference's rule (D <= 110)."""
    sizes, k3 = [], port_engine.batched_kkt_solve

    def counted_k3(A, b):
        sizes.append(A.shape[-1])
        return k3(A, b)

    monkeypatch.setattr(port_engine, "batched_kkt_solve", counted_k3)
    with _OneThread() if k == 4 else nullcontext():
        assert _modes_agree(k, False, seed=k, mesh=mesh) < 5e-12
    assert sizes and all(k3_admits(D, 1) for D in sizes)
    eng = _port(mesh, k)
    # one call of each mode, each bucket solved once in the KKT one
    assert sorted(sizes) == sorted(eng.kkt_size(key)[0] for key in eng.buckets)
    if mesh == "unstructured7":
        assert {75, 90, 105, 120} <= set(sizes)
    if k == 4:
        assert 208 in sizes and k3_admits(208, 1)
        assert k3_plan(208, 1, torch.float64) == "cluster4x4x16"


def _lu_pivots(A):
    """The pivots u_jj of the pivot-free LU of each system in A (N, D, D),
    in K3's elimination order, and the growth max|U| / max|A| of each."""
    A0, A = A, A.clone()
    piv, umax = [], A.new_zeros(A.shape[0])
    for j in range(A.shape[-1]):
        piv.append(A[:, j, j].clone())
        umax = torch.maximum(umax, A[:, j, j:].abs().amax(-1))
        lcol = A[:, j + 1:, j] / A[:, j, j, None]
        A[:, j + 1:, j + 1:] -= lcol[:, :, None] * A[:, j, None, j + 1:]
    return torch.stack(piv, dim=1), umax / A0.abs().amax((-1, -2))


# (k, D) -> smallest |u_jj| / max|A| of the pivot-free order on the
# operands of ``_pivot_free_matches_pivoted`` (two RHS), measured here.  At
# RT4 it is ~200x below RT3's D = 120 because of scale, not growth: the
# smallest pivot of each system falls in the flux block, mostly on the
# cells' interior RT4 dofs (steps 41-121 of D = 130-208, never in the
# constraint block), where the RT4 mass matrix's entries span more (max|A|
# 1.1-3.7e4 a system against 2.4-2.7e2 at RT3); against the largest
# entry of its own row of A it is 3.9e-5 or more (1.6e-3 at RT3), and no
# entry of U exceeds max|A| (growth 0.02-0.07 at RT4, 0.38-0.41 at RT3).
PIVOT_RATIOS = {(3, 120): 3.06e-5, (4, 130): 1.48e-7, (4, 156): 1.45e-7,
                (4, 182): 1.06e-7, (4, 208): 1.73e-7}


def _pivot_free_matches_pivoted(k, D, seed, monkeypatch):
    """On the engine's own D-sized KKT operands at RT ``k`` on the
    unstructured mesh, which the reference solves with pivoting and the
    port through K3 without: the plain pivot-free solve is within
    1e-12 * max|x| of ``torch.linalg.solve`` (on one thread: the CPU
    MKL hang), no pivot of the pivot-free order comes near zero (smallest
    |u_jj| / max|A| above 1e-8 and within 10x of ``PIVOT_RATIOS``;
    against its own row of A above 1e-6) and the elimination does not
    grow the entries."""
    eng = _port("unstructured7", k)
    ops = []
    solve = eng._kkt_solve

    def record(A, b):
        if A.shape[-1] == D:
            ops.append((A.reshape(-1, D, D), b.reshape(-1, D, 1)))
        return solve(A, b)

    monkeypatch.setattr(eng, "_kkt_solve", record)
    eng.equilibrate(*_data(_MESHES["unstructured7"](gen), k, seed=seed))
    assert ops and k3_admits(D, 1)
    for A, b in ops:
        x_plain = batched_kkt_solve_plain(A, b)
        with _OneThread():
            x_lin = torch.linalg.solve(A, b)
        scale = float(x_lin.abs().max())
        assert float((x_plain - x_lin).abs().max()) <= 1e-12 * scale
        piv, growth = _lu_pivots(A)
        ratio = float(piv.abs().min() / A.abs().max())
        assert ratio > 1e-8, ratio
        assert ratio > 0.1 * PIVOT_RATIOS[k, D], ratio
        assert float((piv.abs() / A.abs().amax(-1)).min()) > 1e-6
        assert float(growth.max()) < 1.0


def test_kkt_d120_pivot_free_matches_pivoted(monkeypatch):
    """The D = 120 KKT systems of the unstructured mesh at k = 3 (interior
    8-cell patches), on K3's wide route on the card."""
    _pivot_free_matches_pivoted(3, 120, 33, monkeypatch)


@pytest.mark.parametrize("D", [130, 156, 182, 208])
def test_kkt_rt4_pivot_free_matches_pivoted(D, monkeypatch):
    """RT4's D > 128 systems (interior patches of 5-8 cells), every one
    that ``k3_admits`` admits, on K3's cluster route on the card."""
    _pivot_free_matches_pivoted(4, D, 45, monkeypatch)


@pytest.mark.parametrize("k", [2, 3])
def test_kkt_equals_semiexplicit_essential(k):
    """Flux-essential boundary with the pinned explicit step on the
    semi-explicit side and identity rows on the KKT side."""
    assert _modes_agree(k, True, seed=20 + k) < 5e-12


def test_kkt_f32_within_bar_of_f64():
    """The bar chip_smoke.py holds the f32 KKT path to on the card:
    within 1e-3 * max|x| of the f64 KKT result, on unit_square(8)."""
    msh = gen.unit_square(8)
    rng = np.random.default_rng(0)
    dp = rng.normal(size=(1, msh.num_cells, 2, 3))
    dr = rng.normal(size=(1, msh.num_cells, 3))
    fk = np.where(msh.is_boundary_facet, 1, 0)[None]
    bv = np.zeros((1, msh.num_facets, 2))
    xs = {}
    for dt in (torch.float32, torch.float64):
        eng = EqlbEngine(FunctionSpace(msh, "RT", 2), build_patches(msh),
                         dtype=dt, device="cpu")
        eng.mode = "kkt"
        xs[dt] = eng.equilibrate(dp, dr, fk, bv).double()
    x64 = xs[torch.float64]
    assert (xs[torch.float32] - x64).abs().max() <= 1e-3 * x64.abs().max()


def test_kkt_rejects_transposed_inputs():
    eng = _port("crossed", 1)
    msh = eng.mesh
    dp, dr, fk, bv = _data(msh, 1, seed=1)
    dpT, drT = eng.put_transposed(dp, dr)
    with pytest.raises(ValueError, match="transposed_inputs"):
        eng.equilibrate(dpT, drT, fk, bv, transposed_inputs=True)
