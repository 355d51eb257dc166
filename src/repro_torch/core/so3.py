"""Exact SO(3) machinery needed by the port's constant builders (numpy).

A subset of the reference ``repro.core.so3``: the real spherical harmonics
that sample the collocation grids and the torus conversion tensors (numpy)
and their differentiable torch twin `real_sph_harm_torch`; the exact
Clebsch-Gordan pieces behind the Wigner recursion's CG blocks
(`constants.cg_11_blocks`) and the CG baseline (`core.cg`); the exact real
Gaunt tensor (`real_gaunt_tensor`, the dense oracle); and the real Wigner-D
matrices (`wigner_D_real_packed`) that the equivariance checks rotate with,
and the zyz Euler angles of a rotation (`euler_from_matrix_zyz`,
`align_to_z_angles`); the S^2 grid of the EquiformerV2 family's
activations (`s2_grid_matrices`).
The numpy code runs once per shape, in float64 or exact rational arithmetic,
and is cached by `core.constants`.

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
import torch

from .irreps import idx, num_coeffs

__all__ = [
    "wigner_3j",
    "clebsch_gordan",
    "gaunt_complex",
    "real_sph_harm",
    "real_sph_harm_torch",
    "sphere_quadrature",
    "real_gaunt_tensor",
    "real_clebsch_gordan_block",
    "u_matrix",
    "wigner_d_small",
    "wigner_d_complex",
    "wigner_D_real",
    "wigner_D_real_packed",
    "rotation_matrix_zyz",
    "euler_from_matrix_zyz",
    "align_to_z_angles",
    "s2_grid_matrices",
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
def gaunt_complex(l1: int, m1: int, l2: int, m2: int, l3: int, m3: int) -> float:
    """Gaunt coefficient for *complex* SH: int Y_{l1m1} Y_{l2m2} Y_{l3m3} dOmega."""
    if (l1 + l2 + l3) % 2 != 0:
        return 0.0
    if m1 + m2 + m3 != 0:
        return 0.0
    w0 = wigner_3j(l1, l2, l3, 0, 0, 0)
    if w0 == 0.0:
        return 0.0
    w = wigner_3j(l1, l2, l3, m1, m2, m3)
    return math.sqrt((2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1) / (4 * math.pi)) * w0 * w


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


def real_sph_harm_torch(L: int, xyz: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`real_sph_harm` (differentiable, unrolled in l, m).

    The same polynomial in (x, y, z) as the reference's `real_sph_harm_jax`:
    no trig, well defined at the poles.  xyz [..., 3] unit vectors ->
    [..., (L+1)^2] in xyz's dtype.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    norms = _sh_norms(L)
    # P~_l^m(z) recurrences, unrolled (L is static)
    P: dict[tuple[int, int], torch.Tensor] = {(0, 0): torch.ones_like(z)}
    for m in range(1, L + 1):
        P[(m, m)] = P[(m - 1, m - 1)] * (2 * m - 1)
    for m in range(0, L):
        P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
    for m in range(0, L + 1):
        for l in range(m + 2, L + 1):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    A = [torch.ones_like(z)]
    B = [torch.zeros_like(z)]
    for m in range(1, L + 1):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(y * A[m - 1] + x * B[m - 1])
    cols = []
    sq2 = math.sqrt(2.0)
    for l in range(L + 1):
        for m in range(-l, l + 1):
            if m == 0:
                cols.append(float(norms[l, 0]) * P[(l, 0)])
            elif m > 0:
                cols.append(sq2 * float(norms[l, m]) * P[(l, m)] * A[m])
            else:
                cols.append(sq2 * float(norms[l, -m]) * P[(l, -m)] * B[-m])
    return torch.stack(cols, dim=-1)


# --------------------------------------------------------------------------
# quadrature (exact for bandlimited integrands)
# --------------------------------------------------------------------------


def sphere_quadrature(bandlimit: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes xyz [N,3] and weights w [N] exact for spherical polynomials of
    degree <= bandlimit.

    Gauss-Legendre in cos(t) x uniform trapezoid in p.
    """
    n_t = bandlimit // 2 + 2
    n_p = bandlimit + 2
    xg, wg = np.polynomial.legendre.leggauss(n_t)  # x = cos t
    p = 2 * math.pi * np.arange(n_p) / n_p
    wp = 2 * math.pi / n_p
    ct = xg[:, None] + 0 * p[None, :]
    st = np.sqrt(np.maximum(0.0, 1 - ct**2))
    xyz = np.stack(
        [st * np.cos(p)[None, :], st * np.sin(p)[None, :], ct], axis=-1
    ).reshape(-1, 3)
    w = (wg[:, None] * wp * np.ones_like(p)[None, :]).reshape(-1)
    return xyz, w


@lru_cache(maxsize=None)
def s2_grid_matrices(L: int, res: int, m_max: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(to_grid, from_grid), each [res * res, (L+1)^2] float64: the S^2 grid
    of the EquiformerV2 family's pointwise activations.

    Points: ``res`` Gauss-Legendre nodes z_a = cos(t_a) (weights w_a) times
    ``res`` uniform angles p_b = 2 pi b / res, latitude-major (g = a res +
    b).  to_grid[g, i] = s_l S_i(t_a, p_b) samples a signal; from_grid[g, i]
    = s_l w_a (2 pi / res) S_i(t_a, p_b) projects a grid back.  With
    ``m_max`` below L (a signal of orders |m| <= m_max only, as in an edge
    frame) the degrees l > m_max carry EquiformerV2's rescale s_l =
    sqrt((2l+1) / (2 m_max + 1)) in both; otherwise s_l = 1.  The round
    trip from_grid^T to_grid is s_l^2 on each degree (the identity without
    the rescale) once res >= L + 1 and res > 2 L."""
    z, w = np.polynomial.legendre.leggauss(res)
    p = 2 * math.pi * np.arange(res) / res
    st = np.sqrt(np.maximum(0.0, 1 - z ** 2))
    xyz = np.stack([np.outer(st, np.cos(p)), np.outer(st, np.sin(p)),
                    np.outer(z, np.ones(res))], -1).reshape(-1, 3)
    Y = real_sph_harm(L, xyz)
    ls = np.concatenate([np.full(2 * l + 1, l) for l in range(L + 1)])
    scale = np.ones(num_coeffs(L))
    if m_max is not None and m_max < L:
        big = ls > m_max
        scale[big] = np.sqrt((2 * ls[big] + 1) / (2 * m_max + 1))
    to_grid = Y * scale
    quad = np.repeat(w, res) * (2 * math.pi / res)
    return to_grid, to_grid * quad[:, None]


# --------------------------------------------------------------------------
# real Gaunt tensor (exact, separated polar x azimuthal integrals)
# --------------------------------------------------------------------------


def _azimuthal_triple(m1: int, m2: int, m3: int) -> float:
    """int_0^{2pi} F_{m1} F_{m2} F_{m3} dp with F_m = cos(mp) (m>0), 1 (m=0),
    sin(|m|p) (m<0).  Closed form."""
    neg = sum(1 for m in (m1, m2, m3) if m < 0)
    a, b, c = abs(m1), abs(m2), abs(m3)
    if neg == 1 or neg == 3:
        return 0.0  # odd number of sines integrates to zero

    def d(x: int) -> float:  # delta(x == 0)
        return 1.0 if x == 0 else 0.0

    pi = math.pi
    if neg == 0:  # cos cos cos (m=0 => cos(0)=1 consistent)
        val = 0.5 * pi * (d(a + b - c) + d(a - b + c) + d(-a + b + c) + d(a + b + c))
        if a == 0 and b == 0 and c == 0:
            val = 2 * pi
        return val
    # neg == 2: one cos (or const), two sin. Put sines as (s1, s2), cos as co.
    sins = [abs(m) for m in (m1, m2, m3) if m < 0]
    cosv = [abs(m) for m in (m1, m2, m3) if m >= 0][0]
    s1, s2 = sins
    # int sin(s1 p) sin(s2 p) cos(co p) dp
    val = 0.5 * pi * (d(s1 - s2 + cosv) + d(s1 - s2 - cosv) - d(s1 + s2 + cosv) - d(s1 + s2 - cosv))
    if s1 == 0 or s2 == 0:
        return 0.0  # sin(0)=0
    return val


@lru_cache(maxsize=None)
def _theta_table(L: int, n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Theta_{l,m}(t_k) table [ (l,m) -> node ] on GL nodes, and weights."""
    xg, wg = np.polynomial.legendre.leggauss(n_nodes)
    P = _legendre_sinm_poly(L, xg)  # P~ = P/sin^m
    norms = _sh_norms(L)
    st = np.sqrt(np.maximum(0.0, 1 - xg**2))
    tab = np.zeros((L + 1, L + 1, n_nodes))
    for l in range(L + 1):
        for m in range(l + 1):
            tab[l, m] = norms[l, m] * P[l, m] * st**m
    return tab, wg


@lru_cache(maxsize=None)
def real_gaunt_tensor(L1: int, L2: int, L3: int) -> np.ndarray:
    """Dense real-Gaunt tensor G[(L1+1)^2, (L2+1)^2, (L3+1)^2] (float64).

    G[i1, i2, i3] = int S_{i1} S_{i2} S_{i3} dOmega.  Exact: the polar
    integrand is a polynomial in cos t, integrated by Gauss-Legendre.
    """
    Lm = max(L1, L2, L3)
    # polar integrand has degree <= L1+L2+L3 (+even sin powers) in cos t
    n_nodes = (L1 + L2 + L3) // 2 + 2
    tab, wg = _theta_table(Lm, n_nodes)
    G = np.zeros((num_coeffs(L1), num_coeffs(L2), num_coeffs(L3)))
    sq2 = math.sqrt(2.0)

    def phi_coeff(m: int) -> float:
        return 1.0 if m == 0 else sq2  # S includes sqrt2 for m != 0

    for l1 in range(L1 + 1):
        for l2 in range(L2 + 1):
            l3lo = abs(l1 - l2)
            for l3 in range(l3lo, min(L3, l1 + l2) + 1):
                if (l1 + l2 + l3) % 2 != 0:
                    continue
                for m1 in range(-l1, l1 + 1):
                    for m2 in range(-l2, l2 + 1):
                        # azimuthal selection: |m3| in {| |m1|+-|m2| |}
                        cands = {abs(abs(m1) + abs(m2)), abs(abs(m1) - abs(m2))}
                        for am3 in cands:
                            if am3 > l3:
                                continue
                            for m3 in ({0} if am3 == 0 else {am3, -am3}):
                                az = _azimuthal_triple(m1, m2, m3)
                                if az == 0.0:
                                    continue
                                pol = float(
                                    np.dot(wg, tab[l1, abs(m1)] * tab[l2, abs(m2)] * tab[l3, abs(m3)])
                                )
                                val = az * pol * phi_coeff(m1) * phi_coeff(m2) * phi_coeff(m3)
                                G[idx(l1, m1), idx(l2, m2), idx(l3, m3)] = val
    return G



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


# --------------------------------------------------------------------------
# Wigner matrices
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _d_coeff_table(l: int) -> list:
    """Precomputed sqrt-factorial prefactors for the small-d formula."""
    rows = []
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = math.sqrt(
                _fact(l + mp) * _fact(l - mp) * _fact(l + m) * _fact(l - m)
            )
            kmin = max(0, m - mp)
            kmax = min(l + m, l - mp)
            terms = []
            for k in range(kmin, kmax + 1):
                den = (
                    _fact(l + m - k) * _fact(k) * _fact(mp - m + k) * _fact(l - mp - k)
                )
                terms.append((k, (-1) ** (mp - m + k) * pref / den))
            rows.append(((mp, m), terms))
    return rows


def wigner_d_small(l: int, beta: float) -> np.ndarray:
    """Wigner small-d matrix d^l_{m'm}(beta) [2l+1, 2l+1]."""
    c, s = math.cos(beta / 2), math.sin(beta / 2)
    d = np.zeros((2 * l + 1, 2 * l + 1))
    for (mp, m), terms in _d_coeff_table(l):
        v = 0.0
        for k, coef in terms:
            v += coef * c ** (2 * l - mp + m - 2 * k) * s ** (mp - m + 2 * k)
        d[l + mp, l + m] = v
    return d


def wigner_d_complex(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Complex Wigner D^l_{m'm}(alpha,beta,gamma) = e^{-i m' a} d(b) e^{-i m g}.

    Sign convention (the reference's): the *real* basis transport U D U^H
    satisfies S^l(R r) = D_real S^l(r) with R = Rz(a) Ry(b) Rz(g), so this is
    conj() of the usual QM state-rotation D.
    """
    d = wigner_d_small(l, beta)
    ms = np.arange(-l, l + 1)
    return np.exp(1j * alpha * ms)[:, None] * d * np.exp(1j * gamma * ms)[None, :]


@lru_cache(maxsize=None)
def _u_pair(l: int) -> tuple[np.ndarray, np.ndarray]:
    U = u_matrix(l)
    return U, U.conj().T


def wigner_D_real(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Real-basis Wigner D for rotation R = Rz(alpha) Ry(beta) Rz(gamma):
    S^l(R r) = D S^l(r)."""
    U, Uh = _u_pair(l)
    D = U @ wigner_d_complex(l, alpha, beta, gamma) @ Uh
    if np.abs(D.imag).max() >= 1e-9:
        raise ArithmeticError(f"real Wigner D^{l} has an imaginary part "
                              f"{np.abs(D.imag).max():.2e}")
    return D.real


def wigner_D_real_packed(L: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Block-diagonal real Wigner D over the packed (L+1)^2 layout."""
    n = num_coeffs(L)
    out = np.zeros((n, n))
    for l in range(L + 1):
        sl = slice(l * l, (l + 1) * (l + 1))
        out[sl, sl] = wigner_D_real(l, alpha, beta, gamma)
    return out


def rotation_matrix_zyz(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """R = Rz(alpha) Ry(beta) Rz(gamma) acting on column vectors."""

    def rz(a):
        return np.array(
            [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]]
        )

    def ry(a):
        return np.array(
            [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
        )

    return rz(alpha) @ ry(beta) @ rz(gamma)


def euler_from_matrix_zyz(R: np.ndarray) -> tuple[float, float, float]:
    """Inverse of `rotation_matrix_zyz` (beta in [0, pi]; at the gimbal
    poles gamma is 0 and the rotation folds into alpha)."""
    beta = math.acos(max(-1.0, min(1.0, R[2, 2])))
    if abs(R[2, 2]) < 1 - 1e-12:
        alpha = math.atan2(R[1, 2], R[0, 2])
        gamma = math.atan2(R[2, 1], -R[2, 0])
    else:
        alpha = math.atan2(R[1, 0], R[0, 0]) if R[2, 2] > 0 else math.atan2(-R[1, 0], -R[0, 0])
        gamma = 0.0
    return alpha, beta, gamma


def align_to_z_angles(r: np.ndarray) -> tuple[float, float, float]:
    """zyz Euler angles of a rotation R with R @ r_hat = (0, 0, 1): the
    zenith alignment under which the SH filter keeps only its m = 0
    components, S_{l,m}(e_z) = delta_{m0} sqrt((2l+1)/4pi)."""
    r = np.asarray(r, dtype=np.float64)
    r = r / np.linalg.norm(r)
    theta = math.acos(max(-1.0, min(1.0, r[2])))
    psi = math.atan2(r[1], r[0])
    # Ry(-theta) Rz(-psi) sends r to +z
    return euler_from_matrix_zyz(rotation_matrix_zyz(0.0, -theta, -psi))
