"""Exact polynomial arithmetic on the reference triangle / interval.

Setup-time (host, NumPy) machinery used to construct finite-element basis
functions as explicit bivariate coefficient arrays.  A scalar polynomial is
stored as ``C`` with ``p(x, y) = sum_ij C[i, j] x**i y**j``.

This replaces the reference's dependency on Basix tabulation
(``cpp/dolfinx_eqlb/base/KernelData.cpp:146-188`` uses
``basix::FiniteElement::tabulate``): here every element basis is an explicit
polynomial, so values / gradients / divergences at arbitrary points are exact
and trivially differentiable.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "poly_eval",
    "poly_diff",
    "poly_mul",
    "tri_integrate",
    "dubiner_basis",
    "legendre_shifted",
    "legendre_norm2",
    "monomial_exponents",
]


def poly_eval(C: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Evaluate ``p(x,y) = sum C[i,j] x^i y^j`` at points ``pts`` (..., 2)."""
    x = pts[..., 0]
    y = pts[..., 1]
    # Horner in y inside Horner in x
    res = np.zeros_like(x, dtype=np.float64)
    for i in range(C.shape[0] - 1, -1, -1):
        row = np.zeros_like(y, dtype=np.float64)
        for j in range(C.shape[1] - 1, -1, -1):
            row = row * y + C[i, j]
        res = res * x + row
    return res


def poly_diff(C: np.ndarray, axis: int) -> np.ndarray:
    """Exact partial derivative of a coefficient array (axis 0 = x, 1 = y)."""
    n, m = C.shape
    if axis == 0:
        if n == 1:
            return np.zeros((1, m))
        D = C[1:, :] * np.arange(1, n)[:, None]
        return D
    else:
        if m == 1:
            return np.zeros((n, 1))
        D = C[:, 1:] * np.arange(1, m)[None, :]
        return D


def poly_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Product of two bivariate coefficient arrays (2D convolution)."""
    na, ma = A.shape
    nb, mb = B.shape
    out = np.zeros((na + nb - 1, ma + mb - 1))
    for i in range(na):
        for j in range(ma):
            if A[i, j] != 0.0:
                out[i : i + nb, j : j + mb] += A[i, j] * B
    return out


_FACT_CACHE: dict[tuple[int, int], float] = {}


def _mono_int(i: int, j: int) -> float:
    """integral of x^i y^j over the unit triangle {x,y>=0, x+y<=1} = i!j!/(i+j+2)!"""
    key = (i, j)
    v = _FACT_CACHE.get(key)
    if v is None:
        v = float(
            math.factorial(i) * math.factorial(j) / math.factorial(i + j + 2)
        )
        _FACT_CACHE[key] = v
    return v


def tri_integrate(C: np.ndarray) -> float:
    """Exact integral of a coefficient-array polynomial over the unit triangle."""
    n, m = C.shape
    s = 0.0
    for i in range(n):
        for j in range(m):
            if C[i, j] != 0.0:
                s += C[i, j] * _mono_int(i, j)
    return s


def monomial_exponents(degree: int) -> list[tuple[int, int]]:
    """(i, j) exponent pairs with i+j <= degree, graded ordering."""
    out = []
    for d in range(degree + 1):
        for i in range(d, -1, -1):
            out.append((i, d - i))
    return out


# --- Dubiner (orthonormal) basis on the unit triangle -----------------------


def _jacobi_rec(n: int, alpha: int, u_coeffs: list[np.ndarray]) -> None:
    """Extend list of coefficient arrays for P_n^{(alpha,0)}(2y-1) in y.

    u_coeffs holds 2D arrays (constant in x). Recurrence for Jacobi
    polynomials with beta = 0 evaluated at z = 2y-1.
    """
    # z = 2y - 1 as a coeff array
    z = np.array([[-1.0, 2.0]])  # -1 + 2y   (rows: x-degree, cols: y-degree)
    while len(u_coeffs) <= n:
        m = len(u_coeffs) - 1  # have P_0..P_m, build P_{m+1}
        k = m + 1
        a1 = 2 * k * (k + alpha) * (2 * k + alpha - 2)
        a2 = (2 * k + alpha - 1) * (alpha * alpha)
        a3 = (2 * k + alpha - 2) * (2 * k + alpha - 1) * (2 * k + alpha)
        a4 = 2 * (k + alpha - 1) * (k - 1) * (2 * k + alpha)
        # a2 + a3 * z with z = 2y - 1  ->  [[a2 - a3, 2*a3]]
        lin = np.array([[a2 - a3, 2.0 * a3]])
        term = poly_mul(u_coeffs[m], lin)
        if m >= 1:
            prev = a4 * u_coeffs[m - 1]
            nr = max(term.shape[0], prev.shape[0])
            nc = max(term.shape[1], prev.shape[1])
            T = np.zeros((nr, nc))
            T[: term.shape[0], : term.shape[1]] += term
            T[: prev.shape[0], : prev.shape[1]] -= prev
            term = T
        u_coeffs.append(term / a1)


def dubiner_basis(degree: int) -> list[np.ndarray]:
    """Orthonormal basis of P_degree on the unit triangle, as coeff arrays.

    Modes ordered grouped by total degree d = a + b (a: Legendre-like index),
    mode 0 is the constant.  Orthonormal w.r.t. the L2 inner product on the
    reference triangle {(x,y): x,y >= 0, x + y <= 1}.
    """
    # homogenized Legendre in u = 2x + y - 1, v = 1 - y:
    # Phat_a satisfies (a+1) Phat_{a+1} = (2a+1) u Phat_a - a v^2 Phat_{a-1}
    u = np.array([[-1.0, 1.0], [2.0, 0.0]])  # -1 + y + 2x
    v = np.array([[1.0, -1.0]])  # 1 - y
    v2 = poly_mul(v, v)
    phat = [np.array([[1.0]]), u.copy()]
    for a in range(1, degree + 1):
        nxt = ((2 * a + 1) * poly_mul(u, phat[a]))
        prv = a * poly_mul(v2, phat[a - 1])
        nr = max(nxt.shape[0], prv.shape[0])
        nc = max(nxt.shape[1], prv.shape[1])
        T = np.zeros((nr, nc))
        T[: nxt.shape[0], : nxt.shape[1]] += nxt
        T[: prv.shape[0], : prv.shape[1]] -= prv
        phat.append(T / (a + 1))

    modes: list[np.ndarray] = []
    for d in range(degree + 1):
        for a in range(d, -1, -1):
            b = d - a
            # Jacobi P_b^{(2a+1, 0)}(2y - 1)
            jac: list[np.ndarray] = [np.array([[1.0]])]
            if b > 0:
                alpha = 2 * a + 1
                # P_1^{(alpha,0)}(2y-1) = -1 + (alpha + 2) y
                jac.append(np.array([[-1.0, alpha + 2.0]]))
                _jacobi_rec(b, alpha, jac)
            C = poly_mul(phat[a], jac[b])
            nrm2 = tri_integrate(poly_mul(C, C))
            modes.append(C / math.sqrt(nrm2))
    return modes


# --- shifted Legendre on [0, 1] ---------------------------------------------


def legendre_shifted(degree: int) -> np.ndarray:
    """Coefficients of shifted Legendre P~_m on [0,1]; row m = coeffs in s.

    P~_m(s) = P_m(2s - 1).  Returns array (degree+1, degree+1),
    entry [m, i] multiplies s^i.  P~_m(1-s) = (-1)^m P~_m(s).
    """
    out = np.zeros((degree + 1, degree + 1))
    out[0, 0] = 1.0
    if degree >= 1:
        out[1, 0] = -1.0
        out[1, 1] = 2.0
    for m in range(1, degree):
        # (m+1) P_{m+1}(z) = (2m+1) z P_m - m P_{m-1},  z = 2s-1
        zP = np.zeros(degree + 1)
        zP[1:] += 2.0 * out[m, :-1]
        zP -= out[m]
        out[m + 1] = ((2 * m + 1) * zP - m * out[m - 1]) / (m + 1)
    return out


def legendre_norm2(m: int) -> float:
    """integral over [0,1] of P~_m(s)^2 ds = 1 / (2m + 1)."""
    return 1.0 / (2 * m + 1)
