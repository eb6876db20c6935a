"""K5, the semi-explicit stage's load moments (``ops.load_moments``).

On the CPU: the wrapper on CPU tensors is the plain one-hot einsum version
bit for bit, on every bucket of the crossed and the unstructured mesh; the
plain version matches the JAX package's ``load_moments_bl`` (1e-12
relative); the wrapper refuses what the kernel does not take; a CPU
``equilibrate`` launches nothing; a semi-explicit call past the kernel's
degrees is refused on the card before any work and runs on the CPU.  On
the card only (marker ``card``): the kernel against the plain version
(1e-13 relative in f64, 1e-6 in f32), one launch a bucket in an
``equilibrate``, and the refusal on a real card engine.  This module
imports JAX only inside the JAX comparison, so the card tests run on a
machine without it, past the JAX set-up of ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_load_moments.py -m card
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch import ops
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import unit_square, unit_square_unstructured
from dolfinx_eqlb_tpu_torch.ops.load_moments import (
    load_moments, load_moments_plain,
)
from dolfinx_eqlb_tpu_torch.utils import profiling

torch.set_num_threads(2)

_MESHES = {
    "crossed": lambda: unit_square(3),
    "unstructured": lambda: unit_square_unstructured(4),
}
_TABLES = ("cells_bl", "combo_bl", "J_bl", "K_bl", "signs_bl", "detJ_bl")
_REFS = ("RhatC", "T3C", "hatgC")


def _engine(mesh, k, device="cpu", dtype=torch.float64, chunk=None):
    msh = _MESHES[mesh]()
    return EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                      dtype=dtype, device=device,
                      max_patches_per_bucket=chunk)


@pytest.fixture(scope="module")
def cpu_engines():
    cache = {}

    def get(mesh, k):
        if (mesh, k) not in cache:
            cache[mesh, k] = _engine(mesh, k)
        return cache[mesh, k]

    return get


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda", 0)


def _dprT(eng, n_rhs, seed):
    k, nc = eng.k, eng.mesh.num_cells
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(n_rhs, 3, k * (k + 1) // 2, nc)),
                        dtype=eng.dtype, device=eng.device)


def _args(dprT, dv, refd):
    return (dprT, *(dv[name] for name in _TABLES),
            *(refd[name] for name in _REFS))


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n_rhs", [1, 3])
def test_wrapper_on_cpu_is_the_plain_version(cpu_engines, mesh, k, n_rhs):
    eng = cpu_engines(mesh, k)
    dev, refd = eng._device_tables()
    dprT = _dprT(eng, n_rhs, seed=10 * k + n_rhs)
    kinds = set()
    for key, b in eng.buckets.items():
        args = _args(dprT, dev[key], refd)
        Fv, Fq = load_moments(*args)
        Fv0, Fq0 = load_moments_plain(*args)
        n, P = b.ncells, dev[key]["cells_bl"].shape[1]
        assert Fv.shape == (n, k * (k + 1), n_rhs * P)
        assert Fq.shape == (n, k * (k + 1) // 2, n_rhs * P)
        assert torch.equal(Fv, Fv0) and torch.equal(Fq, Fq0)
        kinds.add(b.is_boundary)
    assert kinds == {False, True}


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_plain_matches_jax(cpu_engines, mesh, k):
    """The JAX package's unrolled combo loop on the port's tables, with two
    right-hand sides folded into the lane axis."""
    jnp = pytest.importorskip("jax.numpy")
    from dolfinx_eqlb_tpu.eqlb.semiexplicit import load_moments_bl as jax_lm

    eng = cpu_engines(mesh, k)
    dev, refd = eng._device_tables()
    dprT = _dprT(eng, 2, seed=100 + k)
    jeng = SimpleNamespace(dtype=jnp.float64)
    jrefd = {name: jnp.asarray(refd[name].numpy()) for name in _REFS}
    for key in eng.buckets:
        Fv, Fq = load_moments_plain(*_args(dprT, dev[key], refd))
        jdv = {name: jnp.asarray(dev[key][name].numpy()) for name in _TABLES}
        jFv, jFq = jax_lm(jeng, key, jnp.asarray(dprT.numpy()), jdv, jrefd)
        for got, want in ((Fv.numpy(), np.asarray(jFv)),
                          (Fq.numpy(), np.asarray(jFq))):
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _bad(case, args):
    """``args`` of one bucket made into what the wrapper must refuse."""
    a = list(args)
    if case == "dprT_rank":
        a[0] = a[0][0]
    elif case == "signs_shape":
        a[5] = a[5][:, :-1].contiguous()
    elif case == "rhat_shape":
        a[7] = a[7][:, :, :1].contiguous()
    elif case == "half_dtype":
        a = [t.half() if t.is_floating_point() else t for t in a]
    elif case == "mixed_dtype":
        a[3] = a[3].float()
    elif case == "int32_cells":
        a[1] = a[1].int()
    elif case == "meta_device":
        a = [t.to("meta") for t in a]
    elif case == "mixed_device":
        a[4] = a[4].to("meta")
    elif case == "non_contiguous":
        a[3] = a[3].transpose(1, 2)
    return a


@pytest.mark.parametrize("case", [
    "dprT_rank", "signs_shape", "rhat_shape", "half_dtype", "mixed_dtype",
    "int32_cells", "meta_device", "mixed_device", "non_contiguous"])
def test_wrapper_refuses(cpu_engines, case):
    eng = cpu_engines("crossed", 2)
    dev, refd = eng._device_tables()
    key = next(iter(eng.buckets))
    args = _args(_dprT(eng, 1, seed=0), dev[key], refd)
    with pytest.raises(ValueError):
        load_moments(*_bad(case, args))


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
    nb = len(eng.buckets)
    before = ops.launches()["K5"]
    with profiling.recording() as recs:
        _call(eng, seed=3)
    assert ops.launches()["K5"] == before
    spans = [r for r in recs if r.name == "se.load_moments"]
    assert len(spans) == nb
    assert all(r.attrs.get("route") == "plain" for r in spans)


def test_degree_past_the_kernel_refused_on_the_card_runs_on_cpu():
    """RT5: the CPU engine runs the semi-explicit mode on the plain route;
    the same engine on a card device refuses the call at its entry (before
    any upload, so no card is needed to see it), and not in the KKT mode."""
    eng = _engine("crossed", 5)
    with profiling.recording() as recs:
        x = _call(eng, seed=5)
    assert torch.isfinite(x).all()
    assert {r.attrs.get("route") for r in recs
            if r.name == "se.load_moments"} == {"plain"}
    eng.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="RT degree 1-4"):
        _call(eng, seed=5)
    eng.mode = "kkt"
    eng._check_options()


def test_degree_rule_is_one_constant(monkeypatch):
    """The RT degrees the semi-explicit card kernels take are one constant,
    ``ops._build.SE_KERNEL_DEGREES``: cut to (1, 2), an engine on a card
    device refuses RT3 at its entry with a message built from it, and K5's
    accepted moment counts (ndg = k (k + 1) / 2) follow."""
    from dolfinx_eqlb_tpu_torch.ops import _build
    from dolfinx_eqlb_tpu_torch.ops.load_moments import _kernel_degree

    monkeypatch.setattr(_build, "SE_KERNEL_DEGREES", (1, 2))
    eng = _engine("crossed", 3)
    eng.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="RT degree 1-2, not 3"):
        _call(eng, seed=7)
    eng.mode = "kkt"
    eng._check_options()
    assert [_kernel_degree(ndg) for ndg in (1, 3)] == [1, 2]
    for ndg in (6, 10):
        with pytest.raises(ValueError, match="RT degree 1-2, not"):
            _kernel_degree(ndg)
    with pytest.raises(ValueError, match="no RT degree"):
        _kernel_degree(4)


@pytest.mark.card
def test_degree_past_the_kernel_refused_on_a_card_engine(card):
    eng = _engine("crossed", 5, device=card)
    before = ops.launches()["K5"]
    with pytest.raises(ValueError, match="RT degree 1-4"):
        _call(eng, seed=6)
    assert ops.launches()["K5"] == before
    eng.mode = "kkt"
    eng._check_options()


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n_rhs", [1, 3])
@pytest.mark.parametrize("chunk", [None, 7])
def test_kernel_matches_plain(card, dtype, k, n_rhs, chunk):
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    eng = _engine("unstructured", k, device=card, dtype=dtype, chunk=chunk)
    dev, refd = eng._device_tables()
    dprT = _dprT(eng, n_rhs, seed=1000 + 10 * k + n_rhs)
    before = ops.launches()["K5"]
    for key in eng.buckets:
        args = _args(dprT, dev[key], refd)
        Fv, Fq = load_moments(*args)
        Fv0, Fq0 = load_moments_plain(*args)
        torch.cuda.synchronize(card)
        for got, want in ((Fv, Fv0), (Fq, Fq0)):
            assert got.shape == want.shape
            assert torch.isfinite(got).all()
            err = (got - want).abs().max().item()
            assert err <= tol * want.abs().max().item()
    assert ops.launches()["K5"] == before + len(eng.buckets)


@pytest.mark.card
@pytest.mark.parametrize("mesh", sorted(_MESHES))
def test_equilibrate_launches_one_a_bucket(card, mesh):
    eng = _engine(mesh, 2, device=card, chunk=9)
    before = ops.launches()["K5"]
    with profiling.recording() as recs:
        _call(eng, seed=4)
    torch.cuda.synchronize(card)
    assert ops.launches()["K5"] == before + len(eng.buckets)
    spans = [r for r in recs if r.name == "se.load_moments"]
    assert [r.attrs.get("route") for r in spans] == ["kernel"] * len(spans)
    assert len(spans) == len(eng.buckets)
