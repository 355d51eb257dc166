"""Gaunt tensor product stages in torch: SH <-> Fourier conversions and the
Hermitian 2D convolution (the paper's Section 3.2/3.3).

Layouts follow the reference ``repro.core.gaunt``: SH features
[..., (L+1)^2]; dense grids [..., 2L+1 (u), 2L+1 (v)]; half grids
[..., 2L+1 (u), L+1 (v >= 0)], all centered (index L <-> frequency 0).
The grid FFTs run on ``torch.fft`` (cuFFT on the card).
"""
from __future__ import annotations

import torch

from . import constants as _const
from .irreps import degree_slices, l_array

__all__ = [
    "sh_to_fourier",
    "fourier_to_sh",
    "sh_to_fourier_bydeg",
    "conv2d_herm",
    "expand_degree_weights",
    "unpack_hermitian",
]

_CNAME = {torch.complex64: "complex64", torch.complex128: "complex128"}


def expand_degree_weights(w: torch.Tensor, L: int) -> torch.Tensor:
    """w [..., L+1] per-degree -> [..., (L+1)^2] packed broadcast."""
    return w[..., _const.to_torch(l_array(L), w.device, torch.int64)]


def _conv_tensor(conversion: str, L: int, cdtype, device) -> torch.Tensor:
    if conversion == "dense":
        y = _const.y_dense(L, _CNAME[cdtype])
    elif conversion == "half":
        y = _const.y_half(L, _CNAME[cdtype])
    else:
        raise ValueError(f"unknown conversion {conversion!r} (expected 'dense'|'half')")
    return _const.to_torch(y, device)


def sh_to_fourier(x: torch.Tensor, L: int, conversion: str = "dense",
                  cdtype=torch.complex64) -> torch.Tensor:
    """x [..., (L+1)^2] real -> centered grid: 'dense' [..., 2L+1, 2L+1],
    'half' [..., 2L+1, L+1] (the v >= 0 columns)."""
    y = _conv_tensor(conversion, L, cdtype, x.device)
    return torch.einsum("...i,iuv->...uv", x.to(y.dtype), y)


def fourier_to_sh(F: torch.Tensor, Lf: int, Lout: int, conversion: str = "dense",
                  rdtype=torch.float32) -> torch.Tensor:
    """Centered grid -> real irreps [..., (Lout+1)^2] ('dense' expects the
    full grid, 'half' the Hermitian half form)."""
    cname = _CNAME[F.dtype]
    if conversion == "dense":
        z = _const.z_dense(Lf, Lout, cname)
    elif conversion == "half":
        z = _const.z_half(Lf, Lout, cname)
    else:
        raise ValueError(f"unknown conversion {conversion!r} (expected 'dense'|'half')")
    zt = _const.to_torch(z, F.device)
    return torch.einsum("...uv,uvk->...k", F, zt).real.to(rdtype)


def sh_to_fourier_bydeg(x: torch.Tensor, L: int, conversion: str = "dense",
                        cdtype=torch.complex64) -> torch.Tensor:
    """Degree-resolved conversion: x [..., (L+1)^2] -> [..., L+1, n, nv].

    Slice l is the grid contribution of degree l alone, so any per-degree
    reweighting w . x converts as ``einsum('...l,...luv->...uv', w, Fl)`` —
    one conversion serves every reweighted copy of the same tensor."""
    y = _conv_tensor(conversion, L, cdtype, x.device)
    xc = x.to(y.dtype)
    parts = [torch.einsum("...i,iuv->...uv", xc[..., sl], y[sl])
             for sl in degree_slices(L)]
    return torch.stack(parts, dim=-3)


def unpack_hermitian(Fh: torch.Tensor, L: int) -> torch.Tensor:
    """Half form [..., 2L+1, L+1] -> full grid via F[-u,-v] = conj(F[u,v])."""
    neg = torch.conj(torch.flip(Fh[..., 1:], dims=(-2, -1)))
    return torch.cat([neg, Fh], dim=-1)


def _herm_spatial(Fh: torch.Tensor, L: int, N: int) -> torch.Tensor:
    """Half grid [..., 2L+1, L+1] -> real spatial samples [..., N, N].

    After the full inverse transform over u, each row's v-spectrum is
    Hermitian in v alone, so `irfft2` applies to the standard-order half
    spectrum (u = 0..L first, u = -L..-1 wrapped to the end)."""
    lead = Fh.shape[:-2]
    pos = Fh[..., L:, :]
    neg = Fh[..., :L, :]
    mid = Fh.new_zeros(lead + (N - 2 * L - 1, L + 1))
    G = torch.cat([pos, mid, neg], dim=-2)
    G = torch.cat([G, Fh.new_zeros(lead + (N, N // 2 + 1 - (L + 1)))], dim=-1)
    return torch.fft.irfft2(G, s=(N, N)) * (N * N)


def conv2d_herm(F1h: torch.Tensor, F2h: torch.Tensor) -> torch.Tensor:
    """Full 2D convolution of Hermitian half grids -> product half grid.

    F1h [..., 2L1+1, L1+1], F2h [..., 2L2+1, L2+1] -> [..., 2Lt+1, Lt+1],
    Lt = L1+L2: multiply the real spatial samples on an alias-free N x N grid
    and transform back with `rfft2` (the reference's method='rfft').
    """
    L1 = (F1h.shape[-2] - 1) // 2
    L2 = (F2h.shape[-2] - 1) // 2
    Lt = L1 + L2
    N = 2 * Lt + 2
    s = _herm_spatial(F1h, L1, N) * _herm_spatial(F2h, L2, N)
    H = torch.fft.rfft2(s) / (N * N)
    return torch.cat([H[..., N - Lt:, : Lt + 1], H[..., : Lt + 1, : Lt + 1]], dim=-2)
