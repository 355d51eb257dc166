"""SH <-> 2D Fourier basis conversion tensors (the paper's Section 3.2), numpy.

Forward (`y` coefficients): every real SH S_{l,m}, extended to the torus
double cover of the sphere (theta in [0, 2pi)), is an exactly bandlimited 2D
trigonometric polynomial
    S_{l,m}(t, p) = sum_{|u|<=l, v = +-m} y^{l,m}_{u,v} e^{i(u t + v p)};
y is obtained exactly by sampling the analytic continuation on an N x N grid
with N > 2L and taking a 2D FFT.

Backward (`z` coefficients): the SH coefficients of a function known by its
torus Fourier series come from sphere-domain projection
    z^{l,m}_{u,v} = int_0^{2pi} int_0^pi e^{i(u t + v p)} S_{l,m} sin t dt dp,
which separates into a closed-form azimuthal delta and an exact theta
integral (finite trig expansion, int_0^pi e^{int} dt in closed form).

The `packed` forms expose the v = +-m block sparsity as stacked per-|m|
matmuls (the paper's O(L^3) conversion).  The `half` forms keep only the
v >= 0 columns, which determine the whole grid of a real spherical function
through F[-u,-v] = conj(F[u,v]); `pack_hermitian` is that cut on a grid and
`unpack_hermitian` its inverse.

These builders are pure float64/complex128 numpy and match the reference
``repro.core.fourier`` bit for bit; caching lives in `core.constants`.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from .irreps import idx, num_coeffs
from .so3 import _legendre_sinm_poly, _sh_norms, real_sph_harm

__all__ = [
    "sh_to_fourier_dense",
    "fourier_to_sh_dense",
    "sh_to_fourier_packed",
    "fourier_to_sh_packed",
    "sh_to_fourier_half",
    "fourier_to_sh_half",
    "pack_hermitian",
    "unpack_hermitian",
    "grid_resize",
    "grid_resize_half",
    "s2quad_size",
    "s2quad_angles",
    "s2quad_exact_degree",
    "s2quad_sample_sh",
    "s2quad_project_sh",
    "s2quad_sample_fourier",
    "s2quad_project_fourier",
]


def _torus_samples(L: int) -> tuple[np.ndarray, int]:
    """Sample all real SH (analytically continued) on an N x N torus grid."""
    N = 2 * L + 2  # > bandlimit 2L+1
    t = 2 * math.pi * np.arange(N) / N
    p = 2 * math.pi * np.arange(N) / N
    tt, pp = np.meshgrid(t, p, indexing="ij")
    # Cartesian continuation: sin t may be negative for t > pi, which is
    # exactly the torus extension
    xyz = np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], axis=-1
    )
    S = real_sph_harm(L, xyz.reshape(-1, 3)).reshape(N, N, num_coeffs(L))
    return S, N


def sh_to_fourier_dense(L: int) -> np.ndarray:
    """y[(L+1)^2, 2L+1 (u), 2L+1 (v)] complex128, centered (index L <-> freq 0)."""
    S, N = _torus_samples(L)
    F = np.fft.fft2(S, axes=(0, 1)) / (N * N)
    out = np.zeros((num_coeffs(L), 2 * L + 1, 2 * L + 1), dtype=np.complex128)
    for u in range(-L, L + 1):
        for v in range(-L, L + 1):
            out[:, L + u, L + v] = F[u % N, v % N, :]
    out[np.abs(out) < 1e-14] = 0.0
    return out


@lru_cache(maxsize=None)
def _theta_fourier_integrals(L: int, u_max: int) -> np.ndarray:
    """I[l, m, u + u_max] = int_0^pi e^{iut} Theta_{l,m}(t) sin t dt.

    Returns [L+1, L+1, 2*u_max+1] complex, valid for m <= l; exact.
    """
    # h_{l,m}(t) = Theta_{l,m}(t) sin(t) is a trig polynomial of degree <= L+1
    N = 2 * (L + 2) + 1
    t = 2 * math.pi * np.arange(N) / N
    ct, st = np.cos(t), np.sin(t)
    P = _legendre_sinm_poly(L, ct)
    norms = _sh_norms(L)
    h = np.zeros((L + 1, L + 1, N))
    for l in range(L + 1):
        for m in range(l + 1):
            h[l, m] = norms[l, m] * P[l, m] * st ** m * st
    hk = np.fft.fft(h, axis=-1) / N  # coefficient of e^{+ikt} at index k % N

    def E(n: int) -> complex:  # int_0^pi e^{int} dt
        if n == 0:
            return math.pi
        if n % 2 == 0:
            return 0.0
        return 2j / n

    ks = np.arange(-(L + 1), L + 2)
    hk_c = np.zeros((L + 1, L + 1, len(ks)), dtype=np.complex128)
    for i, k in enumerate(ks):
        hk_c[:, :, i] = hk[:, :, k % N]
    out = np.zeros((L + 1, L + 1, 2 * u_max + 1), dtype=np.complex128)
    for ui, u in enumerate(range(-u_max, u_max + 1)):
        Evec = np.array([E(u + k) for k in ks])
        out[:, :, ui] = hk_c @ Evec
    return out


def fourier_to_sh_dense(Lf: int, Lout: int) -> np.ndarray:
    """z[2Lf+1 (u), 2Lf+1 (v), (Lout+1)^2] complex128 (centered u, v).

    x^{(l)}_m = Re( sum_{u,v} F[u, v] z[u, v, idx(l,m)] )  for F the centered
    torus-Fourier coefficient grid of a real spherical function.
    """
    I = _theta_fourier_integrals(Lout, Lf)
    z = np.zeros((2 * Lf + 1, 2 * Lf + 1, num_coeffs(Lout)), dtype=np.complex128)
    sq2 = math.sqrt(2.0)
    for l in range(Lout + 1):
        for m in range(0, l + 1):
            if m > Lf:
                continue
            th = I[l, m]
            if m == 0:
                # psi integral of e^{ivp}: 2pi delta_{v,0}
                z[:, Lf + 0, idx(l, 0)] += 2 * math.pi * th
            else:
                # S_{l,m} carries sqrt2 cos(mp): sqrt2 pi (delta_{v,m} + delta_{v,-m})
                z[:, Lf + m, idx(l, m)] += sq2 * math.pi * th
                z[:, Lf - m, idx(l, m)] += sq2 * math.pi * th
                # S_{l,-m} carries sqrt2 sin(mp): sqrt2 i pi (delta_{v,m} - delta_{v,-m})
                z[:, Lf + m, idx(l, -m)] += sq2 * 1j * math.pi * th
                z[:, Lf - m, idx(l, -m)] += -sq2 * 1j * math.pi * th
    z[np.abs(z) < 1e-14] = 0.0
    return z


# --------------------------------------------------------------------------
# packed (block-sparse, O(L^3)) forms
# --------------------------------------------------------------------------


def sh_to_fourier_packed(L: int, y: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Exploit v = +-m sparsity as per-|m| stacked matmuls.

    Returns (yp, yn), each [L+1 (mm), 2 (plane), L+1 (l), 2L+1 (u)] complex:
    yp[mm, 0, l] is the v = +mm column of y for input idx(l, +mm), and
    yp[mm, 1, l] the same column for input idx(l, -mm) (zero for l < mm and
    for plane 1 at mm = 0); yn likewise for the v = -mm column.  With the
    input packed as xb[plane, mm, l] (`constants.pack_index`), the grid's
    v = +-mm columns are  sum_{plane, l} xb * y{p,n}.
    """
    y = sh_to_fourier_dense(L) if y is None else y
    n = 2 * L + 1
    yp = np.zeros((L + 1, 2, L + 1, n), dtype=np.complex128)  # [mm, plane, l, u]
    for mm in range(L + 1):
        for l in range(mm, L + 1):
            yp[mm, 0, l] = y[idx(l, mm), :, L + mm]
            if mm > 0:
                yp[mm, 1, l] = y[idx(l, -mm), :, L + mm]
    yn = np.zeros((L + 1, 2, L + 1, n), dtype=np.complex128)
    for mm in range(L + 1):
        for l in range(mm, L + 1):
            yn[mm, 0, l] = y[idx(l, mm), :, L - mm]
            if mm > 0:
                yn[mm, 1, l] = y[idx(l, -mm), :, L - mm]
    return yp, yn


def fourier_to_sh_packed(Lf: int, Lout: int, z: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Packed z: per-|m| matrices over u for the v=+m and v=-m columns.

    zp[mm, plane, l, u]: x[idx(l, +-mm)] += Re( F[:, Lf+mm] . zp[mm, plane, l] )
    zn likewise for the v = -mm column.
    """
    z = fourier_to_sh_dense(Lf, Lout) if z is None else z
    n = 2 * Lf + 1
    zp = np.zeros((Lout + 1, 2, Lout + 1, n), dtype=np.complex128)
    zn = np.zeros((Lout + 1, 2, Lout + 1, n), dtype=np.complex128)
    for mm in range(min(Lf, Lout) + 1):
        for l in range(mm, Lout + 1):
            zp[mm, 0, l] = z[:, Lf + mm, idx(l, mm)]
            if mm > 0:
                # mm = 0 would duplicate the v=0 column already in zp
                zn[mm, 0, l] = z[:, Lf - mm, idx(l, mm)]
                zp[mm, 1, l] = z[:, Lf + mm, idx(l, -mm)]
                zn[mm, 1, l] = z[:, Lf - mm, idx(l, -mm)]
    return zp, zn


# --------------------------------------------------------------------------
# half (Hermitian, real-input) forms
# --------------------------------------------------------------------------


def sh_to_fourier_half(L: int, y: np.ndarray | None = None) -> np.ndarray:
    """yh[(L+1)^2, 2L+1 (u), L+1 (v >= 0)]: the v >= 0 columns of `y`."""
    y = sh_to_fourier_dense(L) if y is None else y
    return np.ascontiguousarray(y[:, :, L:])


def fourier_to_sh_half(Lf: int, Lout: int, z: np.ndarray | None = None) -> np.ndarray:
    """zh[2Lf+1 (u), Lf+1 (v >= 0), (Lout+1)^2] with the v < 0 columns folded in.

    For Hermitian F,  Re(sum_{u,v} F[u,v] z[u,v,k])
      = Re( sum_u F[u,0] z[u,0,k]
            + sum_{u,v>0} F[u,v] (z[u,v,k] + conj(z[-u,-v,k])) ),
    so  x = Re(einsum('...uv,uvk->...k', Fh, zh))  is exact.
    """
    z = fourier_to_sh_dense(Lf, Lout) if z is None else z
    zh = z[:, Lf:, :].copy()
    zh[:, 1:, :] += np.conj(z[::-1, Lf - 1 :: -1, :])
    return zh


def pack_hermitian(F, L: int):
    """Full centered grid [..., 2L+1, 2L+1] -> half form [..., 2L+1, L+1].

    Keeps the v >= 0 columns; lossless only for grids of *real* spherical
    functions (every grid `sh_to_fourier` makes of real SH coefficients,
    and every convolution of such grids).
    """
    return F[..., L:]


def unpack_hermitian(Fh, L: int):
    """Half form [..., 2L+1, L+1] -> full grid via F[-u,-v] = conj(F[u,v]):
    numpy arrays and torch tensors alike."""
    if isinstance(Fh, np.ndarray):
        neg = np.conj(np.flip(Fh[..., 1:], axis=(-2, -1)))
        return np.concatenate([neg, Fh], axis=-1)
    import torch

    neg = torch.conj(torch.flip(Fh[..., 1:], dims=(-2, -1)))
    return torch.cat([neg, Fh], dim=-1)


def _pad(F, widths):
    """Zero-pad the last two axes by ((u0, u1), (v0, v1)): numpy arrays and
    torch tensors alike."""
    if isinstance(F, np.ndarray):
        return np.pad(F, [(0, 0)] * (F.ndim - 2) + list(widths))
    import torch.nn.functional as tF

    (u0, u1), (v0, v1) = widths
    return tF.pad(F, (v0, v1, u0, u1))


def grid_resize(F, L_from: int, L_to: int):
    """Centered bandlimit change of a full grid: zero-pad up or truncate down.

    Padding (L_to > L_from) is exact.  Truncation is exact only when the
    resident function is bandlimited at L_to; an exit that needs a
    *projection* to lower degrees goes through `fourier_to_sh` instead.
    """
    d = L_to - L_from
    if d == 0:
        return F
    if d > 0:
        return _pad(F, ((d, d), (d, d)))
    c = -d
    return F[..., c:-c, c:-c]


def grid_resize_half(Fh, L_from: int, L_to: int):
    """`grid_resize` for half grids: u pads both sides, v pads the far end."""
    d = L_to - L_from
    if d == 0:
        return Fh
    if d > 0:
        return _pad(Fh, ((d, d), (0, d)))
    c = -d
    return Fh[..., c:-c, : L_to + 1]


# --------------------------------------------------------------------------
# S^2 quadrature: Gauss-Legendre theta nodes x equispaced phi
# --------------------------------------------------------------------------
#
# The torus product grid above is exact by bandlimit counting for products
# of bandlimited signals; general pointwise nonlinearities need a true
# sphere quadrature.  Gauss-Legendre nodes in cos(theta) with n_t points
# integrate polynomials in cos(theta) up to degree 2 n_t - 1 exactly; the
# equispaced phi sum with n_p points kills e^{im phi} exactly for
# 0 < |m| < n_p.  A product of real SH of total degree D integrates exactly
# iff D <= s2quad_exact_degree(n_t, n_p) = min(2 n_t - 1, n_p - 1).
# `s2quad_size(L, os)` picks (n_t, n_p) = (os (L+1), 2 os (L+1)), so the
# default os = 2 resolves degree 4L + 3.


def s2quad_size(L: int, os: int = 2) -> tuple[int, int]:
    """Default (n_theta, n_phi) for a degree-L signal at oversampling ``os``."""
    if os < 1:
        raise ValueError(f"oversampling factor must be >= 1, got {os}")
    nt = os * (L + 1)
    return nt, 2 * nt


def s2quad_angles(n_theta: int, n_phi: int):
    """(theta [n_t], w_theta [n_t], phi [n_p]): Gauss-Legendre nodes and
    weights in x = cos(theta), and uniform phi."""
    x, w = np.polynomial.legendre.leggauss(n_theta)
    return np.arccos(x), w, 2 * math.pi * np.arange(n_phi) / n_phi


def s2quad_exact_degree(n_theta: int, n_phi: int) -> int:
    """Max total SH degree whose sphere integral this quadrature is exact for."""
    return min(2 * n_theta - 1, n_phi - 1)


def _s2quad_xyz(n_theta: int, n_phi: int) -> np.ndarray:
    theta, _, phi = s2quad_angles(n_theta, n_phi)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    return np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], axis=-1
    ).reshape(-1, 3)


def s2quad_sample_sh(L: int, n_theta: int, n_phi: int) -> np.ndarray:
    """A [(L+1)^2, G]: real SH on the quadrature grid (float64); ``x @ A``
    turns packed SH coefficients into sample values."""
    return real_sph_harm(L, _s2quad_xyz(n_theta, n_phi)).T.copy()


def s2quad_project_sh(Lout: int, n_theta: int, n_phi: int) -> np.ndarray:
    """P [G, (Lout+1)^2]: P[g, k] = w_g Y_k(omega_g), w_g = w_GL(theta_g)
    2 pi / n_phi; ``V @ P`` recovers the coefficients exactly while the
    sampled content's degree + Lout stays within `s2quad_exact_degree`."""
    _, w, _ = s2quad_angles(n_theta, n_phi)
    S = real_sph_harm(Lout, _s2quad_xyz(n_theta, n_phi))
    wg = np.repeat(w, n_phi) * (2 * math.pi / n_phi)
    return S * wg[:, None]


def s2quad_sample_fourier(L: int, n_theta: int, n_phi: int) -> np.ndarray:
    """M [2 (2L+1)(L+1), G]: a resident half grid, stacked as the real
    vector [Re F; Im F], to its sphere samples at the quadrature angles in
    one real matmul (theta in (0, pi) lies inside the torus domain)."""
    theta, _, phi = s2quad_angles(n_theta, n_phi)
    us = np.arange(-L, L + 1)
    vs = np.arange(0, L + 1)
    Et = np.exp(1j * np.outer(us, theta))
    Ep = np.exp(1j * np.outer(vs, phi))
    c = np.where(vs == 0, 1.0, 2.0)
    E = np.einsum("ua,vb,v->uvab", Et, Ep, c).reshape(
        (2 * L + 1) * (L + 1), n_theta * n_phi)
    return np.concatenate([E.real, -E.imag], axis=0)


def s2quad_project_fourier(L: int, n_theta: int, n_phi: int) -> np.ndarray:
    """Z [G, 2L+1, L+1] complex: quadrature samples -> half grid, the
    projection to SH and the SH -> Fourier conversion as one matrix."""
    P = s2quad_project_sh(L, n_theta, n_phi)
    y = sh_to_fourier_half(L)
    return np.einsum("gk,kuv->guv", P, y)
