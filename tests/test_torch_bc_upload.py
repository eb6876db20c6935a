"""The boundary data's upload in ``EqlbEngine.equilibrate``.

The stages read ``facet_kind`` and ``bvals`` only at the boundary spokes of
the boundary buckets, which are the mesh's boundary facets.  From host
arrays the engine uploads only those rows (``_bc_input``) into full-width
buffers of its own; of tensors on its device it copies those rows into the
same buffers on the device.

On the CPU: the rows are the mesh's boundary facets (a rank's subset on
the sharded engine); every output from host arrays is bit for bit the
output from the full arrays as tensors, in the semi-explicit mode at
k = 1-4, the KKT mode at k = 2-3 and with weak symmetry at k = 2, with
mixed flux-essential / primal-Dirichlet boundaries, non-zero data, one or
three right-hand sides, junk in the interior rows of both arrays, an f32
engine and a 2-rank split; the counters ``input_bytes`` /
``input_uploads`` and the ``eqlb.input`` span's ``rows``.  On the card
only (marker ``card``): the input block under
``torch.cuda.set_sync_debug_mode("error")``, arrays changed by the caller
right after a call returns, and 8 calls in flight on 8 boundary data, each
bit for bit its strict result.  This module imports no JAX, so the card
tests run on a machine without it, past the JAX set-up of ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_bc_upload.py -m card
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import unit_square, unit_square_unstructured
from dolfinx_eqlb_tpu_torch.parallel import ShardedEqlbEngine
from dolfinx_eqlb_tpu_torch.utils.profiling import recording

torch.set_num_threads(2)

_MESHES = {
    "crossed3": lambda: unit_square(3),
    "crossed4": lambda: unit_square(4),
    "crossed5": lambda: unit_square(5),
    "unstructured7": lambda: unit_square_unstructured(7),
}


def _engine(mesh, k, mode="semiexplicit", device="cpu",
            dtype=torch.float64, chunk=7, pad=None):
    msh = _MESHES[mesh]()
    eng = EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                     dtype=dtype, device=device, max_patches_per_bucket=chunk,
                     pad_to_multiple=pad)
    eng.mode = mode
    return eng


def _data(msh, k, n_rhs, seed, device="cpu", kinds="mixed"):
    """Random DG data (tensors on ``device``) and host boundary data: every
    boundary facet primal-Dirichlet (kind 1, ``kinds="dirichlet"``) or, at
    random, kind 1 or flux-essential (2) with random facet values."""
    rng = np.random.default_rng(seed)
    nc, nf, ndg = msh.num_cells, msh.num_facets, k * (k + 1) // 2
    dp = torch.as_tensor(rng.normal(size=(n_rhs, nc, 2, ndg)), device=device)
    dr = torch.as_tensor(rng.normal(size=(n_rhs, nc, ndg)), device=device)
    bf = msh.boundary_facets
    fk = np.zeros((n_rhs, nf), dtype=np.int8)
    bv = np.zeros((n_rhs, nf, k))
    fk[:, bf] = 1
    if kinds == "mixed":
        fk[:, bf] = rng.integers(1, 3, size=(n_rhs, len(bf)))
        bv[:, bf] = rng.normal(size=(n_rhs, len(bf), k))
    return dp, dr, fk, bv


def _junk(msh, fk, bv, seed=7):
    """Copies with junk in every interior-facet row of both arrays."""
    rng = np.random.default_rng(seed)
    inner = np.flatnonzero(~msh.is_boundary_facet)
    fk, bv = fk.copy(), bv.copy()
    fk[:, inner] = rng.integers(0, 3, size=(fk.shape[0], len(inner)))
    bv[:, inner] = rng.normal(scale=1e30, size=(bv.shape[0], len(inner),
                                                 bv.shape[2]))
    return fk, bv


def _bits(x):
    """The output's bit patterns (equal NaNs compare equal)."""
    x = x.detach().cpu()
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))


def _full(eng, fk, bv):
    """The full arrays as tensors on the engine's device, whose boundary
    rows the engine copies into its buffers on the device."""
    return (torch.as_tensor(fk, device=eng.device),
            torch.as_tensor(bv, device=eng.device))


@pytest.mark.parametrize("mesh", list(_MESHES))
def test_rows_are_the_boundary_facets(mesh):
    eng = _engine(mesh, 2)
    assert np.array_equal(eng._bf, eng.mesh.boundary_facets)
    bsp = np.concatenate([eng.tables[key]["bspokes"].ravel()
                          for key, b in eng.buckets.items() if b.is_boundary])
    assert np.array_equal(eng._bf, np.unique(bsp))


_CASES = ([("semiexplicit", k) for k in (1, 2, 3, 4)]
          + [("kkt", 2), ("kkt", 3)])


@pytest.mark.parametrize("mesh", ["crossed4", "unstructured7"])
@pytest.mark.parametrize("n_rhs", [1, 3])
@pytest.mark.parametrize("mode,k", _CASES)
def test_host_rows_equal_full_arrays(mode, k, n_rhs, mesh):
    """Host arrays, host arrays with interior junk, and both as full
    tensors give the same bits; the counters count the rows staged."""
    eng = _engine(mesh, k, mode)
    msh = eng.mesh
    dp, dr, fk, bv = _data(msh, k, n_rhs, seed=k + 10 * n_rhs)
    fkj, bvj = _junk(msh, fk, bv)
    want = eng.equilibrate(dp, dr, *_full(eng, fk, bv))
    assert eng.input_bytes == 0 and eng.input_uploads == 0
    _assert_bitwise(eng.equilibrate(dp, dr, *_full(eng, fkj, bvj)), want)
    _assert_bitwise(eng.equilibrate(dp, dr, fk, bv), want)
    nb = len(msh.boundary_facets)
    assert eng.input_bytes == n_rhs * nb * (1 + 8 * k)
    _assert_bitwise(eng.equilibrate(dp, dr, fkj, bvj), want)
    assert eng.input_uploads == 4
    # the batch-major dof data as host arrays too
    if mode == "semiexplicit":
        _assert_bitwise(
            eng.equilibrate(dp.numpy(), dr.numpy(), fkj, bvj), want)


@pytest.mark.parametrize("mode", ["semiexplicit", "kkt"])
def test_weak_symmetry_host_rows_equal_full_arrays(mode):
    """Two stress rows (weak symmetry) and a third field, k = 2."""
    eng = _engine("crossed4", 2, mode)
    msh = eng.mesh
    dp, dr, fk, bv = _data(msh, 2, 3, seed=5)
    fkj, bvj = _junk(msh, fk, bv)
    want = eng.equilibrate(dp, dr, *_full(eng, fk, bv), weak_symmetry=True)
    _assert_bitwise(eng.equilibrate(dp, dr, fkj, bvj, weak_symmetry=True),
                    want)
    _assert_bitwise(eng.equilibrate(dp, dr, *_full(eng, fkj, bvj),
                                    weak_symmetry=True), want)


def test_f32_engine_casts_the_rows_as_the_device_does():
    eng = _engine("unstructured7", 3, dtype=torch.float32)
    dp, dr, fk, bv = _data(eng.mesh, 3, 2, seed=3)
    dp, dr = dp.float(), dr.float()
    want = eng.equilibrate(dp, dr, *_full(eng, fk, bv))
    got = eng.equilibrate(dp, dr, *_junk(eng.mesh, fk, bv))
    _assert_bitwise(got, want)
    assert eng.input_bytes == 2 * len(eng._bf) * (1 + 4 * 3)


def test_changing_shapes_between_calls():
    """n_rhs 3, 1, 3 and an int64 facet_kind: the engine's buffers follow
    the arrays' shapes and dtypes."""
    eng = _engine("crossed5", 2)
    for n_rhs, seed, idt in ((3, 1, np.int8), (1, 2, np.int8),
                             (3, 3, np.int64)):
        dp, dr, fk, bv = _data(eng.mesh, 2, n_rhs, seed)
        fk = fk.astype(idt)
        want = eng.equilibrate(dp, dr, *_full(eng, fk, bv))
        _assert_bitwise(eng.equilibrate(dp, dr, *_junk(eng.mesh, fk, bv)),
                        want)


def test_dirichlet_boundary_and_caller_changes():
    """All primal Dirichlet with zero data (the benchmark's boundary); the
    caller's arrays changed after the call leave its output as it was."""
    eng = _engine("crossed4", 2)
    dp, dr, fk, bv = _data(eng.mesh, 2, 1, seed=4, kinds="dirichlet")
    want = eng.equilibrate(dp, dr, *_full(eng, fk, bv)).clone()
    got = eng.equilibrate(dp, dr, fk, bv)
    fk[:] = 2
    bv[:] = 1.0
    _assert_bitwise(got, want)


def test_input_span_carries_the_rows():
    eng = _engine("unstructured7", 2, chunk=None)
    dp, dr, fk, bv = _data(eng.mesh, 2, 1, seed=6)
    with recording() as records:
        eng.equilibrate(dp, dr, fk, bv)
    (inp,) = [r for r in records if r.name == "eqlb.input"]
    assert inp.attrs == {"rows": len(eng.mesh.boundary_facets)}


def test_sharded_partial_uploads_the_rank_rows():
    """A 2-rank split (fake process group, rank by rank): each rank's rows
    are the boundary facets of its patches, together all of them, and its
    partial from host arrays (junk inside) is its partial from the full
    tensors bit for bit."""
    eng = _engine("crossed5", 2, chunk=9, pad=2)
    dp, dr, fk, bv = _data(eng.mesh, 2, 2, seed=8)
    fkj, bvj = _junk(eng.mesh, fk, bv)
    rows = []
    for rank in range(2):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=2)
        try:
            sh = ShardedEqlbEngine(eng)
            want = sh.partial(dp, dr, *_full(eng, fk, bv))
            _assert_bitwise(sh.partial(dp, dr, fkj, bvj), want)
            assert sh.local.input_bytes == len(sh.local._bf) * 2 * 17
            rows.append(sh.local._bf)
        finally:
            dist.destroy_process_group()
    assert all(0 < len(r) < len(eng._bf) for r in rows)
    assert np.array_equal(np.union1d(*rows), eng.mesh.boundary_facets)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned staging and the stream run "
                    "only there")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("mode,k", [("semiexplicit", 2), ("kkt", 3)])
def test_input_block_syncs_nothing(card, mode, k):
    """The input block (``_inputs``) from host boundary data and device dof
    data, on the first call (buffers made, rows staged) and after it,
    under ``set_sync_debug_mode("error")``."""
    eng = _engine("unstructured7", k, mode, device=card)
    dp, dr, fk, bv = _data(eng.mesh, k, 3, seed=9, device=card)
    torch.cuda.synchronize(card)
    for _ in range(3):
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._inputs(dp, dr, fk, bv)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert eng.input_bytes == 3 * len(eng._bf) * (1 + 8 * k)
        eng.equilibrate(dp, dr, fk, bv)
    torch.cuda.synchronize(card)


def _strict_and_data(card, mode, k, n=8):
    eng = _engine("unstructured7", k, mode, device=card)
    cases = [_data(eng.mesh, k, 2, seed=20 + i, device=card)
             for i in range(n)]
    strict = []
    for dp, dr, fk, bv in cases:
        strict.append(eng.equilibrate(dp, dr, *_full(eng, fk, bv)))
        torch.cuda.synchronize(card)
    return eng, cases, strict


@pytest.mark.card
@pytest.mark.parametrize("mode,k", [("semiexplicit", 2), ("kkt", 3)])
def test_arrays_changed_after_return(card, mode, k):
    eng, cases, strict = _strict_and_data(card, mode, k)
    for (dp, dr, fk, bv), want in zip(cases, strict):
        fk, bv = fk.copy(), bv.copy()
        got = eng.equilibrate(dp, dr, fk, bv)
        fk[:] = 0
        bv[:] = np.nan
        torch.cuda.synchronize(card)
        _assert_bitwise(got, want)


@pytest.mark.card
@pytest.mark.parametrize("mode,k", [("semiexplicit", 2), ("kkt", 3)])
def test_eight_calls_in_flight(card, mode, k):
    """8 calls queued on 8 boundary data, one sync after the last: each
    output is its strict result, bit for bit."""
    eng, cases, strict = _strict_and_data(card, mode, k)
    out = [eng.equilibrate(dp, dr, *_junk(eng.mesh, fk, bv))
           for dp, dr, fk, bv in cases]
    torch.cuda.synchronize(card)
    for got, want in zip(out, strict):
        _assert_bitwise(got, want)
