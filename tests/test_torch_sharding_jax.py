"""The port's patch sharding against the JAX package's: the four dry-run
cases of ``__graft_entry__.py`` through ``entry.dryrun_multichip(2,
device="cpu")`` (a 2-rank gloo group of spawned processes) against JAX's
``parallel.ShardedEqlbEngine`` on 2 devices of the conftest's virtual CPU
mesh, f64, within 1e-11 * max(1, max|x|); for the grouped Cook case also
the joint weak-symmetry post-pass of both packages on their own sharded
results.  In a file of its own so that xdist runs its JAX compiles beside
``test_torch_sharding.py``'s."""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dolfinx_eqlb_tpu.eqlb import grouping as jgrouping
from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.mesh import generators as jax_gen
from dolfinx_eqlb_tpu.parallel import ShardedEqlbEngine as JaxSharded

from dolfinx_eqlb_tpu_torch import entry as tentry
from dolfinx_eqlb_tpu_torch.eqlb.grouping import grouped_weak_symmetry

torch.set_num_threads(2)

CASES = list(tentry.DRYRUN_CASES)


def _limit(x_ref):
    return 1e-11 * max(1.0, float(np.abs(x_ref).max()))


@pytest.fixture(scope="module")
def port_dryrun():
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    try:
        return tentry.dryrun_multichip(2, device="cpu")
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("patches",))


@pytest.fixture(scope="module")
def jax_sharded(jax_mesh):
    """Each case's JAX engine (padded for 2 devices), its sharded result
    and the case's inputs (the port's NumPy data)."""
    cache = {}

    def get(name):
        if name not in cache:
            spec = tentry.DRYRUN_CASES[name]
            msh = (jax_gen.cook_membrane(spec["n"], spec["n"])
                   if spec.get("mesh_kind") == "cook"
                   else jax_gen.unit_square(spec["n"]))
            eng = JaxEngine(JaxSpace(msh, "RT", spec["k"]), jax_patches(msh),
                            dtype=np.float64, pad_to_multiple=2,
                            max_patches_per_bucket=spec.get(
                                "max_patches_per_bucket"))
            _, args, ws, skip, groups = tentry.dryrun_case(name, 2, "cpu")
            x = JaxSharded(eng, jax_mesh).equilibrate(
                *args, weak_symmetry=ws, ws_skip_nodes=skip)
            cache[name] = eng, args, groups, np.asarray(x)
        return cache[name]

    return get


@pytest.mark.parametrize("name", CASES)
def test_sharded_matches_jax_sharded(port_dryrun, jax_sharded, name):
    _, _, _, x_jax = jax_sharded(name)
    x = port_dryrun[name]["x"]
    assert x.shape == x_jax.shape
    assert np.isfinite(x).all()
    assert np.abs(x - x_jax).max() <= _limit(x_jax)


@pytest.mark.parametrize("name", CASES)
def test_rank_split_matches_jax_sharding(port_dryrun, jax_sharded, name):
    """Both packages split every bucket's padded axis into 2 equal halves:
    the port's rows per rank are half its padded rows, and its patch
    count is the JAX engine's real patch count."""
    eng, *_ = jax_sharded(name)
    ranks = port_dryrun[name]["ranks"]
    assert ranks[0]["rows"] == ranks[1]["rows"]
    n_real = sum(b.npatches for b in eng.buckets.values())
    assert sum(r["patches"] for r in ranks) == n_real


def test_grouped_post_pass_matches_jax(port_dryrun, jax_sharded):
    name = "cook k=2 grouped"
    jeng, args, groups, x_jax = jax_sharded(name)
    fk2 = args[2][:2]
    jgroups, _ = jgrouping.build_groups(jeng, fk2)
    assert jgroups == groups
    y_jax = np.asarray(jgrouping.grouped_weak_symmetry(
        jeng, x_jax[:2], fk2, jgroups))
    engine, *_ = tentry.dryrun_case(name, 2, "cpu")
    y = grouped_weak_symmetry(
        engine, torch.as_tensor(port_dryrun[name]["x"][:2]), fk2,
        groups).numpy()
    assert np.isfinite(y).all()
    assert np.abs(y - y_jax).max() <= _limit(y_jax)
