"""A minimal expression layer (the role UFL plays for the reference).

Port of the JAX package's ``fem/expressions.py``: forms are hand-derived
and data enters them as *expressions*, objects that evaluate to
``(ncells, nq, vs)`` tensors at reference quadrature points, batched over
all cells (cf. reference ``demo_error_estimation.py:95-125``,
``lsolver/projection.py``).

Every expression has a ``device``: a Function's, or for a user callable
the one it was given (``None``: its values stay host tensors).  A callable
keeps its NumPy contract — it gets the physical points from
``mesh.map_points`` on the host and may return NumPy — and its result is
uploaded to the device of the expression it is combined with; an entry
point (projection, interpolation, assembly, the Poisson solver) moves the
final values to its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from .spaces import Function, resolve_device

__all__ = ["Expr", "as_expr", "expr_from_callable", "grad", "div", "comp",
           "cell_scale", "as_vector", "target_device"]


def _on(v: torch.Tensor, device) -> torch.Tensor:
    return v if device is None else v.to(device)


def _first_device(*exprs):
    return next((e.device for e in exprs if e.device is not None), None)


class Expr:
    mesh = None
    value_size = 1
    device = None

    def evaluate(self, qpoints_ref: np.ndarray):
        raise NotImplementedError

    def evaluate_div(self, qpoints_ref: np.ndarray):
        """Divergence (vector expressions), shape (nc, nq, 1)."""
        raise NotImplementedError(f"div of {type(self).__name__}")

    def __add__(self, other):
        return _Sum(self, as_expr(other, self.mesh), 1.0)

    def __sub__(self, other):
        return _Sum(self, as_expr(other, self.mesh), -1.0)

    def __rsub__(self, other):
        return _Sum(as_expr(other, self.mesh), self, -1.0)

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, a):
        if isinstance(a, (int, float)):
            return _Scale(self, float(a))
        return _Prod(self, as_expr(a, self.mesh))

    def __rmul__(self, a):
        return self.__mul__(a)

    def __neg__(self):
        return _Scale(self, -1.0)


class _FuncExpr(Expr):
    def __init__(self, f: Function):
        self.f = f
        self.mesh = f.space.mesh
        self.value_size = f.value_size
        self.device = f.device

    def evaluate(self, q):
        return self.f.evaluate(q)

    def evaluate_div(self, q):
        s = self.f.space
        if s.family in ("RT", "DRT"):
            return self.f.evaluate_div(q)
        if s.family in ("P", "DG") and s.block_size == 2:
            g = self.f.evaluate_grad(q)  # (nc, nq, 2, 2)
            return (g[..., 0, 0] + g[..., 1, 1])[..., None]
        raise NotImplementedError("div of scalar function")


class _CallableExpr(Expr):
    """Wraps ``f(x) -> (..., vs)`` evaluated at physical points (NumPy)."""

    def __init__(self, fn, mesh, value_size=1, device=None):
        self.fn = fn
        self.mesh = mesh
        self.value_size = value_size
        self.device = None if device is None else torch.device(device)

    def evaluate(self, q):
        xq = self.mesh.map_points(np.asarray(q))  # (nc, nq, 2)
        v = torch.as_tensor(np.asarray(self.fn(xq)), dtype=torch.float64,
                            device=self.device)
        if v.ndim == 2:
            v = v[..., None]
        return v


class _Sum(Expr):
    def __init__(self, a, b, sb):
        if a.value_size != b.value_size:
            raise ValueError(f"value sizes differ: {a.value_size} and "
                             f"{b.value_size}")
        self.a, self.b, self.sb = a, b, sb
        self.mesh = a.mesh or b.mesh
        self.value_size = a.value_size
        self.device = _first_device(a, b)

    def evaluate(self, q):
        return (_on(self.a.evaluate(q), self.device)
                + self.sb * _on(self.b.evaluate(q), self.device))

    def evaluate_div(self, q):
        return (_on(self.a.evaluate_div(q), self.device)
                + self.sb * _on(self.b.evaluate_div(q), self.device))


class _Scale(Expr):
    def __init__(self, a, s):
        self.a, self.s = a, s
        self.mesh = a.mesh
        self.value_size = a.value_size
        self.device = a.device

    def evaluate(self, q):
        return self.s * self.a.evaluate(q)

    def evaluate_div(self, q):
        return self.s * self.a.evaluate_div(q)


class _Prod(Expr):
    """Pointwise product; one factor must be scalar."""

    def __init__(self, a, b):
        if 1 not in (a.value_size, b.value_size):
            raise ValueError("a product needs one scalar factor")
        self.a, self.b = a, b
        self.mesh = a.mesh or b.mesh
        self.value_size = max(a.value_size, b.value_size)
        self.device = _first_device(a, b)

    def evaluate(self, q):
        return (_on(self.a.evaluate(q), self.device)
                * _on(self.b.evaluate(q), self.device))


class _GradExpr(Expr):
    def __init__(self, f: Function):
        if f.space.family not in ("P", "DG") or f.space.block_size != 1:
            raise ValueError("grad() needs a scalar P/DG Function")
        self.f = f
        self.mesh = f.space.mesh
        self.value_size = 2
        self.device = f.device

    def evaluate(self, q):
        return self.f.evaluate_grad(q)[:, :, 0, :]  # (nc, nq, 2)


class _DivExpr(Expr):
    def __init__(self, f: Function):
        if f.space.family not in ("RT", "DRT"):
            raise ValueError("div() needs an RT/DRT Function")
        self.f = f
        self.mesh = f.space.mesh
        self.value_size = 1
        self.device = f.device

    def evaluate(self, q):
        return self.f.evaluate_div(q)


class _CompExpr(Expr):
    def __init__(self, a: Expr, i: int):
        self.a, self.i = a, i
        self.mesh = a.mesh
        self.value_size = 1
        self.device = a.device

    def evaluate(self, q):
        return self.a.evaluate(q)[..., self.i : self.i + 1]


def as_expr(obj, mesh=None) -> Expr:
    if isinstance(obj, Expr):
        return obj
    if isinstance(obj, Function):
        return _FuncExpr(obj)
    if callable(obj):
        return _CallableExpr(obj, mesh)
    raise TypeError(f"cannot interpret {obj!r} as expression")


def expr_from_callable(fn, mesh, value_size=1, device=None) -> Expr:
    return _CallableExpr(fn, mesh, value_size, device)


def grad(f: Function) -> Expr:
    return _GradExpr(f)


def div(f) -> Expr:
    if isinstance(f, Function):
        return _DivExpr(f)
    raise TypeError("div() of non-Function expressions not supported")


def comp(e, i: int) -> Expr:
    return _CompExpr(as_expr(e), i)


class _CellScale(Expr):
    """Per-cell scaling (e.g. a DG0 diffusion coefficient)."""

    def __init__(self, a: Expr, values):
        self.a = a
        self.values = values
        self.mesh = a.mesh
        self.value_size = a.value_size
        self.device = a.device or (values.device if isinstance(
            values, torch.Tensor) else None)

    def _scale(self, v):
        v = _on(v, self.device)
        c = torch.as_tensor(self.values, dtype=v.dtype, device=v.device)
        return c[:, None, None] * v

    def evaluate(self, q):
        return self._scale(self.a.evaluate(q))

    def evaluate_div(self, q):
        return self._scale(self.a.evaluate_div(q))


def cell_scale(e, values) -> Expr:
    """Scale an expression by a per-cell constant array (ncells,)."""
    return _CellScale(as_expr(e), values)


class _VectorExpr(Expr):
    def __init__(self, comps):
        self.comps = comps
        self.mesh = comps[0].mesh
        self.value_size = len(comps)
        self.device = _first_device(*comps)

    def evaluate(self, q):
        return torch.cat([_on(c.evaluate(q), self.device)
                          for c in self.comps], dim=-1)


def as_vector(components, mesh=None) -> Expr:
    """Stack scalar expressions into a vector expression (the role of
    ufl.as_vector in the reference demos)."""
    return _VectorExpr([as_expr(c, mesh) for c in components])


def target_device(exprs, device, who: str) -> torch.device:
    """Where an entry point computes: ``device`` if given, else the first
    expression's device, else the CUDA card (raising without one)."""
    if device is None:
        device = _first_device(*exprs)
    return resolve_device(device, who)
