"""K6, the semi-explicit stage's reduced step (``ops.reduced_step``).

On the CPU: the wrapper on CPU tensors is the einsum code the semi-explicit
solve ran before it, bit for bit, on every bucket of the crossed and the
unstructured mesh, chunked or not, interior and boundary; the kernel's
sparse form of E (``ucols`` and ``kernel_uslots``) is the engine's dense
``Zunit``, and a NumPy restatement of the kernel's loop matches the plain
version; the wrapper refuses what the kernel does not take; a CPU
``equilibrate`` launches nothing.  On the card only (marker ``card``): the
kernel against the plain version on the path's own operands (1e-13
relative in f64; in f32 both within the rounding bound of the f64
evaluation, ``_f32_bound``) and one launch a bucket in an
``equilibrate``, split by epilogue.  No JAX here,
so the card tests run on a machine without it, past the JAX set-up of
``conftest.py``:

    python -m pytest --noconftest tests/test_torch_reduced_step.py -m card
"""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch import ops
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.eqlb.semiexplicit import (
    boundary_ess_bl, particular_bl,
)
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import unit_square, unit_square_unstructured
from dolfinx_eqlb_tpu_torch.ops.load_moments import load_moments
from dolfinx_eqlb_tpu_torch.ops.reduced_step import (
    kernel_uslots, reduced_step, reduced_step_plain,
)
from dolfinx_eqlb_tpu_torch.utils import profiling

torch.set_num_threads(2)

_MESHES = {
    "crossed": lambda: unit_square(3),
    "unstructured": lambda: unit_square_unstructured(4),
}
_TABLES = ("patch_idx", "Zunit", "ucols", "exit_idx", "cumalpha_bl", "sel")


def _engine(mesh, k, device="cpu", dtype=torch.float64, chunk=None):
    msh = _MESHES[mesh]()
    return EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                      dtype=dtype, device=device,
                      max_patches_per_bucket=chunk)


@pytest.fixture(scope="module")
def cpu_engines():
    cache = {}

    def get(mesh, k, chunk=None):
        if (mesh, k, chunk) not in cache:
            cache[mesh, k, chunk] = _engine(mesh, k, chunk=chunk)
        return cache[mesh, k, chunk]

    return get


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda", 0)


def _operands(eng, key, dv, n_rhs, seed):
    """Random sp (nflux, X) and Fv (n, nkeep, X) for one bucket."""
    n, nkeep, _, P = dv["Mc_bl"].shape
    b = eng.buckets[key]
    nflux = b.nspokes * eng.k + n * eng.V.element.ndofs_cell
    rng = np.random.default_rng(seed)
    X = n_rhs * P
    return (torch.tensor(rng.normal(size=(nflux, X)), dtype=eng.dtype,
                         device=eng.device),
            torch.tensor(rng.normal(size=(n, nkeep, X)), dtype=eng.dtype,
                         device=eng.device))


def _args(sp, Fv, dv):
    return (sp, Fv, dv["Mc_bl"], *(dv[name] for name in _TABLES),
            dv.get("Ainv_bl"))


def _before(eng, key, sp, Fv, dv):
    """The semi-explicit solve's reduced step as it was written before the
    kernel: the residual's right-hand side through ``reduced_system_bl``'s
    einsums, then on interior buckets the inverse product and the scatter
    back into sp."""
    k, n = eng.k, eng.buckets[key].ncells
    ns = eng.buckets[key].nspokes
    Mc = dv["Mc_bl"]
    nkeep, P = Mc.shape[1], Mc.shape[-1]
    n_rhs = sp.shape[-1] // P
    X = n_rhs * P

    def bx(a):
        if n_rhs == 1:
            return a
        return a.unsqueeze(-2).expand(*a.shape[:-1], n_rhs, P).reshape(
            *a.shape[:-1], n_rhs * P)

    sp_can = sp[dv["patch_idx"]].view(n, nkeep, n_rhs, P)
    msp = torch.einsum("cibp,cbrp->cirp", Mc, sp_can).reshape(n, nkeep, X)
    resid = Fv - msp
    d0 = dv["cumalpha_bl"]
    wen, wex = d0[:n], d0[dv["exit_idx"]]
    bz = torch.einsum("csd,csx->dx", dv["Zunit"], resid)
    bz[0] = (bx(wen) * resid[:, 0] + bx(wex) * resid[:, k]).sum(0)
    if eng.buckets[key].is_boundary:
        return bz
    Dz = bz.shape[0]
    y = torch.einsum("dep,erp->drp", dv["Ainv_bl"],
                     bz.view(Dz, n_rhs, P)).reshape(Dz, X)
    sol = sp
    if Dz > 1:
        sol.index_add_(0, dv["sel"], y[1:])
    sol[0: ns * k: k] += y[0][None] * bx(d0)
    return sol


def _kernel_loop(eng, key, sp, Fv, dv):
    """The kernel's arithmetic in NumPy, lanes vectorised: per cell the
    residual, E by its nonzeros (ucols, kernel_uslots), the d0 column,
    then on interior buckets y = Ainv b_z and the scatter into sp."""
    k = eng.k
    Mc = dv["Mc_bl"].numpy()
    n, nkeep, _, P = Mc.shape
    sp = sp.numpy().copy()
    Fv = Fv.numpy()
    n_rhs = sp.shape[-1] // P
    ucols, pidx = dv["ucols"].numpy(), dv["patch_idx"].numpy()
    exit_idx, sel = dv["exit_idx"].numpy(), dv["sel"].numpy()
    cum = np.tile(dv["cumalpha_bl"].numpy(), (1, n_rhs))  # (ns, X)
    Mcx = np.tile(Mc, (1, 1, 1, n_rhs))
    us = kernel_uslots(k)
    Dz = dv["Zunit"].shape[-1]
    bz = np.zeros((Dz, sp.shape[-1]))
    for c in range(n):
        res = Fv[c] - np.einsum("ibx,bx->ix", Mcx[c], sp[pidx[c]])
        bz[0] += cum[c] * res[0] + cum[exit_idx[c]] * res[k]
        for a in range(len(us)):
            bz[ucols[c, a]] += res[us[a]]
    if eng.buckets[key].is_boundary:
        return bz
    Ainv = np.tile(dv["Ainv_bl"].numpy(), (1, 1, n_rhs))
    y = np.einsum("dex,ex->dx", Ainv, bz)
    sp[sel] += y[1:]
    sp[0: cum.shape[0] * k: k] += y[0] * cum
    return sp


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n_rhs", [1, 2, 3])
@pytest.mark.parametrize("chunk", [None, 7])
def test_wrapper_on_cpu_is_the_einsum_code(cpu_engines, mesh, k, n_rhs,
                                           chunk):
    eng = cpu_engines(mesh, k, chunk)
    dev, _ = eng._device_tables()
    kinds = set()
    for i, key in enumerate(sorted(eng.buckets)):
        dv = dev[key]
        sp, Fv = _operands(eng, key, dv, n_rhs, seed=100 * k + 10 * n_rhs + i)
        sp0 = sp.clone()
        got = reduced_step(*_args(sp, Fv, dv))
        want = _before(eng, key, sp0, Fv, dv)
        boundary = eng.buckets[key].is_boundary
        if boundary:
            assert got.shape == (dv["Zunit"].shape[-1], sp.shape[-1])
        else:
            assert got is sp  # the solution, in place
        assert torch.equal(got, want)
        kinds.add(boundary)
    assert kinds == {False, True}


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_kernel_form_matches_plain(cpu_engines, mesh, k):
    """The sparse E the kernel reads is the engine's dense Zunit, and the
    kernel's loop over cells gives the plain version's result."""
    eng = cpu_engines(mesh, k, 7)
    dev, _ = eng._device_tables()
    for i, key in enumerate(sorted(eng.buckets)):
        dv, st = dev[key], eng.se_static[key]
        np.testing.assert_array_equal(st["uslots"], kernel_uslots(k))
        n = eng.buckets[key].ncells
        E = np.zeros(tuple(dv["Zunit"].shape))
        for c in range(n):
            E[c, kernel_uslots(k), dv["ucols"][c].numpy()] = 1.0
        np.testing.assert_array_equal(E, dv["Zunit"].numpy())
        sp, Fv = _operands(eng, key, dv, 2, seed=500 + i)
        want = reduced_step_plain(*_args(sp.clone(), Fv, dv)).numpy()
        got = _kernel_loop(eng, key, sp, Fv, dv)
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def _bad(case, args):
    """``args`` of one interior bucket made into what the wrapper must
    refuse."""
    a = list(args)
    if case == "sp_rank":
        a[0] = a[0][0]
    elif case == "fv_shape":
        a[1] = a[1][:, :-1].contiguous()
    elif case == "lanes":
        a[0] = a[0][:, :-1].contiguous()
    elif case == "ucols_shape":
        a[5] = a[5][:, :-1].contiguous()
    elif case == "ainv_shape":
        a[9] = a[9][:-1].contiguous()
    elif case == "half_dtype":
        a = [t.half() if t is not None and t.is_floating_point() else t
             for t in a]
    elif case == "mixed_dtype":
        a[2] = a[2].float()
    elif case == "int32_sel":
        a[8] = a[8].int()
    elif case == "meta_device":
        a = [t.to("meta") for t in a]
    elif case == "mixed_device":
        a[9] = a[9].to("meta")
    elif case == "non_contiguous":
        a[1] = a[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mc_patch_axis_strided":
        a[2] = a[2].transpose(2, 3).contiguous().transpose(2, 3)
    return a


@pytest.mark.parametrize("case", [
    "sp_rank", "fv_shape", "lanes", "ucols_shape", "ainv_shape",
    "half_dtype", "mixed_dtype", "int32_sel", "meta_device", "mixed_device",
    "non_contiguous", "mc_patch_axis_strided"])
def test_wrapper_refuses(cpu_engines, case):
    eng = cpu_engines("crossed", 2)
    dev, _ = eng._device_tables()
    key = next(key for key in sorted(eng.buckets)
               if not eng.buckets[key].is_boundary)
    sp, Fv = _operands(eng, key, dev[key], 1, seed=0)
    with pytest.raises(ValueError):
        reduced_step(*_bad(case, _args(sp, Fv, dev[key])))


def _call(eng, seed):
    """One semi-explicit call on random data, every boundary facet kind 1."""
    msh, ndg = eng.mesh, eng.k * (eng.k + 1) // 2
    rng = np.random.default_rng(seed)
    fk = np.where(msh.is_boundary_facet, 1, 0).astype(np.int8)[None]
    return eng.equilibrate(rng.normal(size=(1, msh.num_cells, 2, ndg)),
                           rng.normal(size=(1, msh.num_cells, ndg)), fk,
                           np.zeros((1, msh.num_facets, eng.k)))


def test_cpu_equilibrate_takes_the_plain_route(cpu_engines):
    eng = cpu_engines("crossed", 2)
    before = ops.launches(split=True)["K6"]
    with profiling.recording() as recs:
        _call(eng, seed=3)
    assert ops.launches(split=True)["K6"] == before
    spans = [r for r in recs if r.name == "se.reduced_rhs"]
    assert len(spans) == len(eng.buckets)
    assert all(r.attrs.get("route") == "plain" for r in spans)


def _path_operands(eng, key, dv, refd, n_rhs, seed):
    """sp and Fv as ``solve_bucket_semiexplicit`` hands them to the reduced
    step: K5's moments of random dof data and the explicit step's
    particular solution, the boundary split at random into primal-Dirichlet
    and flux-essential facets with random data on the latter."""
    msh, k = eng.mesh, eng.k
    ndg = k * (k + 1) // 2
    rng = np.random.default_rng(seed)
    dprT = torch.tensor(rng.normal(size=(n_rhs, 3, ndg, msh.num_cells)),
                        dtype=eng.dtype, device=eng.device)
    fk = np.zeros((n_rhs, msh.num_facets), dtype=np.int8)
    bf = msh.boundary_facets
    fk[:, bf] = rng.integers(1, 3, size=(n_rhs, len(bf)))
    bv = np.where((fk == 2)[..., None],
                  rng.normal(size=(n_rhs, msh.num_facets, k)), 0.0)
    fk = torch.as_tensor(fk, device=eng.device)
    bv = torch.tensor(bv, dtype=eng.dtype, device=eng.device)
    Fv, Fq = load_moments(dprT, *(dv[name] for name in (
        "cells_bl", "combo_bl", "J_bl", "K_bl", "signs_bl", "detJ_bl")),
        refd["RhatC"], refd["T3C"], refd["hatgC"])
    ess, hv = (boundary_ess_bl(eng, fk, bv, dv, refd)
               if eng.buckets[key].is_boundary else (None, None))
    return particular_bl(eng, key, Fq, ess, hv, dv), Fv


@pytest.mark.card
@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n_rhs", [1, 3])
@pytest.mark.parametrize("chunk", [None, 7])
def test_kernel_matches_plain(card, mesh, dtype, k, n_rhs, chunk):
    """On the path's own operands; the interior epilogue writes into sp, so
    each version gets a copy.  f64: 1e-13 relative from plain.  f32: two
    f32 sums in another order part by the reduced system's conditioning,
    which grows with k (1.2-7e-6 relative at k = 3-4 on these meshes, the
    plain version as far from the f64 answer), so the kernel and the plain
    version are each held to the f64 evaluation of the same f32 operands
    within the rounding bound of ``_f32_bound``."""
    tol = 1e-13
    eng = _engine(mesh, k, device=card, dtype=dtype, chunk=chunk)
    dev, refd = eng._device_tables()
    before = ops.launches()["K6"]
    for i, key in enumerate(sorted(eng.buckets)):
        dv = dev[key]
        sp, Fv = _path_operands(eng, key, dv, refd, n_rhs,
                                seed=1000 + 10 * k + i)
        got = reduced_step(*_args(sp.clone(), Fv, dv))
        want = reduced_step_plain(*_args(sp.clone(), Fv, dv))
        torch.cuda.synchronize(card)
        assert got.shape == want.shape
        assert torch.isfinite(got).all()
        if dtype == torch.float64:
            err = (got - want).abs().max().item()
            assert err <= tol * want.abs().max().item()
            continue
        exact, bound = _f32_bound(sp, Fv, dv)
        for out in (got, want):
            assert ((out.double() - exact).abs() <= bound).all()
    assert ops.launches()["K6"] == before + len(eng.buckets)


def _f32_bound(sp, Fv, dv):
    """The f64 evaluation of the reduced step on f32 operands and the
    rounding bound of any f32 evaluation, entry by entry: m u times the
    same step on absolute values (|Fv| + |Mc| |sp| through |Ainv|), with
    u = 2^-24 and m = nkeep + 2 n + Dz + 2, the longest chain of roundings
    (the residual's dot product, b_z's sums over the cells, y's dot
    product, the add into sp)."""
    dv64 = {name: t.double() if t.is_floating_point() else t
            for name, t in dv.items()}
    exact = reduced_step_plain(*_args(sp.double(), Fv.double(), dv64))
    absd = dict(dv64, Mc_bl=-dv64["Mc_bl"].abs(),
                cumalpha_bl=dv64["cumalpha_bl"].abs())
    if "Ainv_bl" in dv64:
        absd["Ainv_bl"] = dv64["Ainv_bl"].abs()
    scale = reduced_step_plain(*_args(sp.double().abs(), Fv.double().abs(),
                                      absd))
    n, nkeep = dv["Mc_bl"].shape[:2]
    m = nkeep + 2 * n + dv["Zunit"].shape[-1] + 2
    return exact, m * 2.0 ** -24 * scale


@pytest.mark.card
@pytest.mark.parametrize("mesh", sorted(_MESHES))
def test_equilibrate_launches_one_a_bucket(card, mesh):
    eng = _engine(mesh, 2, device=card, chunk=9)
    interior = sum(not b.is_boundary for b in eng.buckets.values())
    launches = ops.launches()["K6"]
    by = ops.launches(split=True)["K6"]
    with profiling.recording() as recs:
        _call(eng, seed=4)
    torch.cuda.synchronize(card)
    assert ops.launches()["K6"] == launches + len(eng.buckets)
    assert ops.launches(split=True)["K6"] == {
        "inverse": by["inverse"] + interior,
        "rhs": by["rhs"] + len(eng.buckets) - interior}
    spans = [r for r in recs if r.name == "se.reduced_rhs"]
    assert [r.attrs.get("route") for r in spans] == ["kernel"] * len(spans)
    assert len(spans) == len(eng.buckets)
    solves = [r.attrs.get("route") for r in recs
              if r.name == "se.reduced_solve"]
    assert solves.count("inverse") == interior
