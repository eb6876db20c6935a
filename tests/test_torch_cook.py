"""The port's adaptive Cook's-membrane loop (``demos.cook_adaptive``)
against the JAX package's demo (``demos/demo_cook_adaptive.py``), which
has no committed run: two iterations of the demo's configuration (P2
primal, RT3, theta 0.5, the overkill reference), then two at RT2, where
the deficient pure-traction corner patches are grouped
(``eqlb.grouping``).  Cells identical; eta and its components within
1e-9 * eta (f = 0, so eta_osc is roundoff in both packages); the energy
error and I_eff, which come from a difference of
load functionals of two CG solves at rtol 1e-11 / 1e-12, within 1e-6
relative.  f64 on the CPU."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch.demos import cook_adaptive
from dolfinx_eqlb_tpu_torch.eqlb import check_weak_symmetry_condition
from dolfinx_eqlb_tpu_torch.eqlb.grouping import build_groups

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _jax_cook_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_cook_adaptive", REPO / "demos" / "demo_cook_adaptive.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


@pytest.mark.parametrize("degree", [3, 2])
def test_cook_loop_matches_jax(degree):
    want = _jax_cook_demo().run(degree=degree, max_iter=2, verbose=False)
    steps = []
    got = cook_adaptive.run(degree=degree, max_iter=2, verbose=False,
                            device="cpu", step_hook=steps.append)
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        # eta and its components, to 1e-9 of eta: f = 0, so eta_osc is
        # roundoff of both packages
        for i in (1, 4, 5, 6):
            assert abs(g[i] - w[i]) <= 1e-9 * w[1]
        for i in (2, 3):  # err, I_eff
            assert _rel(g[i], w[i]) <= 1e-6
    for step in steps:
        eq = step["eq"]
        groups, _ = build_groups(eq.engine,
                                 eq.boundary_data.facet_kind[:2])
        # the traction edge's corner patches are deficient (2 cells, pure
        # traction); FluxEqlbSE groups them at degree 2
        assert len(groups) > 0
        assert check_weak_symmetry_condition(eq.list_flux,
                                             step["sigma_proj"])
        assert np.isfinite(step["eta"])
