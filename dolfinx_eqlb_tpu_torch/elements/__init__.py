from . import polynomials, quadrature, lagrange, rt  # noqa: F401
from .lagrange import LagrangeTri, DubinerTri, lagrange_cached, dubiner_cached  # noqa: F401
from .rt import HierarchicRT, rt_cached  # noqa: F401
from .quadrature import gauss_interval, gauss_triangle  # noqa: F401
