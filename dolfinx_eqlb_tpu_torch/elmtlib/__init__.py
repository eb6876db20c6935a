"""Hierarchic Raviart-Thomas elements (API mirror of the reference's
``dolfinx_eqlb.elmtlib``, ``python/dolfinx_eqlb/elmtlib/__init__.py:43-45``)."""

from ..elements.rt import HierarchicRT, rt_cached


def create_hierarchic_rt(cell="triangle", degree: int = 1, discontinuous: bool = False):
    """Create the hierarchic RT element (reference
    ``elmtlib/e_raviart_thomas.py:14-196``).  In this framework the element
    is a tabulation object; continuity vs. discontinuity is a property of
    the FunctionSpace family ("RT" vs "DRT"), so ``discontinuous`` only
    selects the intended usage.
    """
    if cell not in ("triangle", None):
        raise ValueError("Only triangular cells supported")
    if degree < 1:
        raise ValueError("Degree must be at least 1")
    return rt_cached(degree)


__all__ = ["create_hierarchic_rt", "HierarchicRT"]
