"""Doerfler marking for adaptive refinement.

Port of the JAX package's ``estimation/marking.py`` (reference
``poisson_adaptive/demo_lshape.py:179-258``): sort the cell-wise error
indicators, mark the smallest set whose accumulated error exceeds
theta * total.  Host NumPy, so both packages mark the same cells for the
same indicators.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["doerfler_mark"]


def doerfler_mark(cell_eta_sq, theta: float) -> np.ndarray:
    """Cell ids to refine: smallest set with sum(eta^2) >= theta * total.

    ``cell_eta_sq``: a NumPy array or a tensor on any device (read to the
    host once)."""
    if isinstance(cell_eta_sq, torch.Tensor):
        cell_eta_sq = cell_eta_sq.detach().cpu().numpy()
    eta = np.asarray(cell_eta_sq)
    order = np.argsort(eta)[::-1]
    csum = np.cumsum(eta[order])
    nmark = int(np.searchsorted(csum, theta * csum[-1])) + 1
    return np.sort(order[:nmark]).astype(np.int64)
