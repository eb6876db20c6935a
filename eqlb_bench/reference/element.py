"""Reference-triangle elements of the plain reference: the hierarchic
Raviart-Thomas element RT_k, the orthonormal Dubiner basis of DG_{k-1} and
the P1 hat functions, with their quadrature.

Frozen copy of the port's plain element code, from
``dolfinx_eqlb_tpu_torch/elements/polynomials.py`` (``poly_eval``,
``poly_diff``, ``poly_mul``, ``tri_integrate``, ``dubiner_basis``,
``legendre_shifted``), ``elements/quadrature.py`` (``gauss_interval``,
``gauss_triangle``, the reference edges) and ``elements/rt.py``
(``HierarchicRT``'s construction), trimmed to what the reference needs.  The
element's dof functionals define what a global RT dof vector means, so the
reference and the program have to share them; everything built on top of
them (topology, patches, element matrices, patch systems) the reference
works out on its own.  NumPy only.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

# local edge i is opposite local vertex i, vertices in ascending local order
LOCAL_EDGES = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int64)
_REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
_REF_EDGE_TANGENT = _REF_VERTS[LOCAL_EDGES[:, 1]] - _REF_VERTS[LOCAL_EDGES[:, 0]]
# rot(t) = (t_y, -t_x), the scaled normal of every facet functional
REF_EDGE_ROTT = np.stack([_REF_EDGE_TANGENT[:, 1], -_REF_EDGE_TANGENT[:, 0]],
                         axis=-1)
# gradients of the P1 hats lambda_0 = 1 - x - y, lambda_1 = x, lambda_2 = y
HAT_GRADS = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def poly_eval(C: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """p(x, y) = sum C[i, j] x^i y^j at ``pts`` (..., 2)."""
    x, y = pts[..., 0], pts[..., 1]
    res = np.zeros_like(x, dtype=np.float64)
    for i in range(C.shape[0] - 1, -1, -1):
        row = np.zeros_like(y, dtype=np.float64)
        for j in range(C.shape[1] - 1, -1, -1):
            row = row * y + C[i, j]
        res = res * x + row
    return res


def poly_diff(C: np.ndarray, axis: int) -> np.ndarray:
    n, m = C.shape
    if axis == 0:
        return np.zeros((1, m)) if n == 1 else C[1:, :] * np.arange(1, n)[:, None]
    return np.zeros((n, 1)) if m == 1 else C[:, 1:] * np.arange(1, m)[None, :]


def poly_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    na, ma = A.shape
    nb, mb = B.shape
    out = np.zeros((na + nb - 1, ma + mb - 1))
    for i in range(na):
        for j in range(ma):
            if A[i, j] != 0.0:
                out[i:i + nb, j:j + mb] += A[i, j] * B
    return out


def _sub(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    out = np.zeros((max(A.shape[0], B.shape[0]), max(A.shape[1], B.shape[1])))
    out[:A.shape[0], :A.shape[1]] += A
    out[:B.shape[0], :B.shape[1]] -= B
    return out


def tri_integrate(C: np.ndarray) -> float:
    """Exact integral over the unit triangle: x^i y^j -> i! j! / (i+j+2)!."""
    return float(sum(
        C[i, j] * math.factorial(i) * math.factorial(j)
        / math.factorial(i + j + 2)
        for i in range(C.shape[0]) for j in range(C.shape[1]) if C[i, j]))


def _jacobi(b: int, alpha: int) -> np.ndarray:
    """P_b^{(alpha, 0)}(2y - 1) as a coefficient array in y."""
    out = [np.array([[1.0]])]
    if b > 0:
        out.append(np.array([[-1.0, alpha + 2.0]]))
    while len(out) <= b:
        m = len(out) - 1
        n = m + 1
        a1 = 2 * n * (n + alpha) * (2 * n + alpha - 2)
        a2 = (2 * n + alpha - 1) * alpha * alpha
        a3 = (2 * n + alpha - 2) * (2 * n + alpha - 1) * (2 * n + alpha)
        a4 = 2 * (n + alpha - 1) * (n - 1) * (2 * n + alpha)
        term = poly_mul(out[m], np.array([[a2 - a3, 2.0 * a3]]))
        if m >= 1:
            term = _sub(term, a4 * out[m - 1])
        out.append(term / a1)
    return out[b]


@lru_cache(maxsize=None)
def dubiner_basis(degree: int) -> tuple[np.ndarray, ...]:
    """Orthonormal basis of P_degree on the unit triangle, grouped by total
    degree, mode 0 the constant sqrt(2)."""
    u = np.array([[-1.0, 1.0], [2.0, 0.0]])  # 2x + y - 1
    v2 = poly_mul(np.array([[1.0, -1.0]]), np.array([[1.0, -1.0]]))
    phat = [np.array([[1.0]]), u.copy()]
    for a in range(1, degree + 1):
        phat.append(_sub((2 * a + 1) * poly_mul(u, phat[a]),
                         a * poly_mul(v2, phat[a - 1])) / (a + 1))
    modes = []
    for d in range(degree + 1):
        for a in range(d, -1, -1):
            C = poly_mul(phat[a], _jacobi(d - a, 2 * a + 1))
            modes.append(C / math.sqrt(tri_integrate(poly_mul(C, C))))
    return tuple(modes)


def legendre_shifted(degree: int) -> np.ndarray:
    """Row m: coefficients in s of P~_m(s) = P_m(2s - 1) on [0, 1]."""
    out = np.zeros((degree + 1, degree + 1))
    out[0, 0] = 1.0
    if degree >= 1:
        out[1, :2] = [-1.0, 2.0]
    for m in range(1, degree):
        zP = np.zeros(degree + 1)
        zP[1:] += 2.0 * out[m, :-1]
        zP -= out[m]
        out[m + 1] = ((2 * m + 1) * zP - m * out[m - 1]) / (m + 1)
    return out


def gauss_interval(npts: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(npts)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_triangle(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Collapsed Gauss rule on the unit triangle, exact to ``degree``."""
    n = max(1, (degree + 3) // 2)
    a, wa = gauss_interval(n)
    A, B = np.meshgrid(a, a, indexing="ij")
    WA, WB = np.meshgrid(wa, wa, indexing="ij")
    return (np.stack([A.ravel(), (B * (1.0 - A)).ravel()], axis=-1),
            (WA * WB * (1.0 - A)).ravel())


@lru_cache(maxsize=None)
def rt_coeffs(k: int) -> np.ndarray:
    """Coefficient arrays (ndofs, 2, k + 1, k + 1) of the hierarchic RT_k
    basis, dual to its functionals in this order: per local edge e the k
    shifted-Legendre moments of v . rot(t_e); the k(k+1)/2 - 1 divergence
    moments against Dubiner modes 1, 2, ...; the (k-1)(k-2)/2 moments
    int v_y x^l y^m, l >= 1, l + m <= k - 2."""
    dub = dubiner_basis(k - 1)
    d = k + 1
    Z = np.zeros((d, d))

    def pad(C):
        out = Z.copy()
        out[:C.shape[0], :C.shape[1]] = C
        return out

    spans = [(pad(C), Z) for C in dub] + [(Z, pad(C)) for C in dub]
    for a in range(k):  # (x, y) x^a y^(k-1-a)
        Cx, Cy = Z.copy(), Z.copy()
        Cx[a + 1, k - 1 - a] = 1.0
        Cy[a, k - a] = 1.0
        spans.append((Cx, Cy))
    nd = k * (k + 2)
    V = np.zeros((nd, nd))
    s, w = gauss_interval(k + 1)
    leg = legendre_shifted(k - 1)
    legv = np.array([np.polyval(leg[m, ::-1], s) for m in range(k)])
    ends = _REF_VERTS[LOCAL_EDGES]  # (3, 2, 2)
    pts_e = ends[:, None, 0] + s[None, :, None] * (ends[:, None, 1]
                                                   - ends[:, None, 0])
    cpts, cw = gauss_triangle(2 * k + 1)
    dubv = np.array([poly_eval(C, cpts) for C in dub])
    ints = [(l, m) for l in range(1, k - 1) for m in range(0, k - 1 - l)]
    for b, (Cx, Cy) in enumerate(spans):
        for e in range(3):
            vn = (REF_EDGE_ROTT[e, 0] * poly_eval(Cx, pts_e[e])
                  + REF_EDGE_ROTT[e, 1] * poly_eval(Cy, pts_e[e]))
            V[e * k:(e + 1) * k, b] = legv @ (w * vn)
        div = pad(poly_diff(Cx, 0))
        dY = poly_diff(Cy, 1)
        div[:dY.shape[0], :dY.shape[1]] += dY
        divv = poly_eval(div, cpts)
        for p in range(1, len(dub)):
            V[3 * k + p - 1, b] = np.sum(cw * divv * dubv[p])
        row = 3 * k + len(dub) - 1
        for n, (l, m) in enumerate(ints):
            mono = cpts[:, 0] ** l * cpts[:, 1] ** m
            V[row + n, b] = np.sum(cw * poly_eval(Cy, cpts) * mono)
    Vinv = np.linalg.inv(V)
    coeffs = np.zeros((nd, 2, d, d))
    for i in range(nd):
        for b in range(nd):
            coeffs[i, 0] += Vinv[b, i] * spans[b][0]
            coeffs[i, 1] += Vinv[b, i] * spans[b][1]
    return coeffs


@lru_cache(maxsize=None)
def reference_tensors(k: int) -> dict[str, np.ndarray]:
    """The reference-cell integrals the patch systems are built from, with
    q the Dubiner modes of DG_{k-1}, phi the RT_k basis, lambda the hats:
    ``Mhat[a, b, i, j] = int phi_ia phi_jb``,
    ``Dhat[i, p] = int div(phi_i) q_p``,
    ``Rhat[l, m, a, i] = int lambda_l q_m phi_ia``,
    ``T3[l, m, p] = int lambda_l q_m q_p``,
    ``cmean[p] = int q_p``."""
    coeffs = rt_coeffs(k)
    pts, w = gauss_triangle(2 * k + 2)
    phi = np.array([[poly_eval(c, pts) for c in ci] for ci in coeffs])
    dphi = np.array([poly_eval(_sub(poly_diff(cx, 0), -poly_diff(cy, 1)), pts)
                     for cx, cy in coeffs])
    q = np.array([poly_eval(C, pts) for C in dubiner_basis(k - 1)])
    lam = np.stack([1.0 - pts[:, 0] - pts[:, 1], pts[:, 0], pts[:, 1]])
    return dict(
        Mhat=np.einsum("x,iax,jbx->abij", w, phi, phi),
        Dhat=np.einsum("x,ix,px->ip", w, dphi, q),
        Rhat=np.einsum("x,lx,mx,iax->lmai", w, lam, q, phi),
        T3=np.einsum("x,lx,mx,px->lmp", w, lam, q, q),
        cmean=np.einsum("x,px->p", w, q),
    )
