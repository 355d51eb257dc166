"""Exact SO(3) machinery needed by the port's constant builders (numpy).

A subset of the reference ``repro.core.so3``: the real spherical harmonics
that sample the collocation grids and the torus conversion tensors, and the
exact Clebsch-Gordan pieces behind the Wigner recursion's CG blocks
(`constants.cg_11_blocks`).  Everything here runs once per shape, in float64
or exact rational arithmetic, and is cached by `core.constants`.

Conventions (identical to the reference, so the builders agree bit for bit):
complex SH carry the Condon-Shortley phase, P_l^m does not; the real
orthonormal SH are

    S_{l,0}  = Y_{l,0}
    S_{l,m}  = sqrt(2) N_{l,m} P_l^m(cos t) cos(m p)    (m > 0)
    S_{l,-m} = sqrt(2) N_{l,m} P_l^m(cos t) sin(m p)    (m > 0)

with N_{l,m} = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!).
"""
from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np

from .irreps import idx, num_coeffs

__all__ = [
    "wigner_3j",
    "clebsch_gordan",
    "real_sph_harm",
    "real_clebsch_gordan_block",
    "u_matrix",
]


@lru_cache(maxsize=None)
def _fact(n: int) -> int:
    return math.factorial(n)


@lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int, m1: int, m2: int, m3: int) -> float:
    """Exact Wigner 3j symbol (float result of an exact rational*sqrt form)."""
    if m1 + m2 + m3 != 0:
        return 0.0
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m3) > l3:
        return 0.0
    tri = Fraction(
        _fact(l1 + l2 - l3) * _fact(l1 - l2 + l3) * _fact(-l1 + l2 + l3),
        _fact(l1 + l2 + l3 + 1),
    )
    pref = tri * Fraction(
        _fact(l1 - m1) * _fact(l1 + m1) * _fact(l2 - m2) * _fact(l2 + m2)
        * _fact(l3 - m3) * _fact(l3 + m3)
    )
    kmin = max(0, l2 - l3 - m1, l1 - l3 + m2)
    kmax = min(l1 + l2 - l3, l1 - m1, l2 + m2)
    s = Fraction(0)
    for k in range(kmin, kmax + 1):
        den = (
            _fact(k)
            * _fact(l1 + l2 - l3 - k)
            * _fact(l1 - m1 - k)
            * _fact(l2 + m2 - k)
            * _fact(l3 - l2 + m1 + k)
            * _fact(l3 - l1 - m2 + k)
        )
        s += Fraction((-1) ** k, den)
    if s == 0:
        return 0.0
    sign = (-1) ** (l1 - l2 - m3)
    return sign * math.copysign(math.sqrt(float(pref * s * s)), float(s))


@lru_cache(maxsize=None)
def clebsch_gordan(l1: int, m1: int, l2: int, m2: int, l3: int, m3: int) -> float:
    """<l1 m1 l2 m2 | l3 m3> from the 3j symbol."""
    if m3 != m1 + m2:
        return 0.0
    w = wigner_3j(l1, l2, l3, m1, m2, -m3)
    if w == 0.0:
        return 0.0
    return (-1) ** (l1 - l2 + m3) * math.sqrt(2 * l3 + 1) * w


@lru_cache(maxsize=None)
def _sh_norms(L: int) -> np.ndarray:
    """norm[l, m] = sqrt((2l+1)/(4pi) (l-m)!/(l+m)!), m<=l (0 elsewhere)."""
    out = np.zeros((L + 1, L + 1))
    for l in range(L + 1):
        for m in range(l + 1):
            out[l, m] = math.sqrt(
                (2 * l + 1) / (4 * math.pi) * float(Fraction(_fact(l - m), _fact(l + m)))
            )
    return out


def _legendre_sinm_poly(L: int, z: np.ndarray) -> np.ndarray:
    """P~_l^m(z) = P_l^m(z)/sin^m(t)  (a polynomial in z), no CS phase.

    Returns array [L+1, L+1, *z.shape] with entry [l, m] valid for m <= l.
    """
    z = np.asarray(z, dtype=np.float64)
    out = np.zeros((L + 1, L + 1) + z.shape, dtype=np.float64)
    out[0, 0] = 1.0
    for m in range(1, L + 1):
        out[m, m] = out[m - 1, m - 1] * (2 * m - 1)
    for m in range(0, L):
        out[m + 1, m] = (2 * m + 1) * z * out[m, m]
    for m in range(0, L + 1):
        for l in range(m + 2, L + 1):
            out[l, m] = ((2 * l - 1) * z * out[l - 1, m] - (l + m - 1) * out[l - 2, m]) / (l - m)
    return out


def real_sph_harm(L: int, xyz: np.ndarray) -> np.ndarray:
    """All real SH S_{l,m}, l<=L at unit vectors xyz[..., 3] -> [..., (L+1)^2]."""
    xyz = np.asarray(xyz, dtype=np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    P = _legendre_sinm_poly(L, z)
    norms = _sh_norms(L)
    # sin^m(t) cos(m p) and sin^m(t) sin(m p) via the Cartesian recurrence
    A = [np.ones_like(z)]
    B = [np.zeros_like(z)]
    for m in range(1, L + 1):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(y * A[m - 1] + x * B[m - 1])
    out = np.zeros(z.shape + (num_coeffs(L),), dtype=np.float64)
    sq2 = math.sqrt(2.0)
    for l in range(L + 1):
        out[..., idx(l, 0)] = norms[l, 0] * P[l, 0]
        for m in range(1, l + 1):
            c = sq2 * norms[l, m]
            out[..., idx(l, m)] = c * P[l, m] * A[m]
            out[..., idx(l, -m)] = c * P[l, m] * B[m]
    return out


@lru_cache(maxsize=None)
def u_matrix(l: int) -> np.ndarray:
    """Unitary change of basis S^l = U Y^l (rows: real m, cols: complex m)."""
    n = 2 * l + 1
    U = np.zeros((n, n), dtype=np.complex128)
    U[l, l] = 1.0
    for m in range(1, l + 1):
        s = 1 / math.sqrt(2)
        U[l + m, l + m] = (-1) ** m * s
        U[l + m, l - m] = s
        U[l - m, l + m] = -1j * (-1) ** m * s
        U[l - m, l - m] = 1j * s
    return U


@lru_cache(maxsize=None)
def real_clebsch_gordan_block(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG block C[2l1+1, 2l2+1, 2l3+1] (real, orthogonality-normalized).

    Transported from the complex-basis CG with the U matrices; the block is
    real up to a global phase, which is stripped.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    Cc = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), dtype=np.complex128)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                Cc[l1 + m1, l2 + m2, l3 + m3] = clebsch_gordan(l1, m1, l2, m2, l3, m3)
    U1, U2, U3 = u_matrix(l1), u_matrix(l2), u_matrix(l3)
    T = np.einsum("ai,bj,ck,ijk->abc", U1, U2, U3.conj(), Cc)
    re, im = np.abs(T.real).max(), np.abs(T.imag).max()
    out = T.real if re >= im else T.imag
    return np.ascontiguousarray(out)
