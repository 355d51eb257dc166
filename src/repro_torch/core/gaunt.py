"""The Gaunt Tensor Product (paper Section 3.2/3.3) in torch — O(L^3) full
products.

Pipeline:  x1, x2  --s2f-->  torus Fourier grids  --2D conv-->  product grid
           --f2s-->  output irreps.

Interchangeable realizations of each stage (all tested equal):
  conversion: 'dense'  — one einsum with the [(L+1)^2, n, n] tensor
              'packed' — per-|m| stacked matmuls exploiting v = +-m sparsity
                         (the paper's O(L^3) path)
              'half'   — the Hermitian half form (v >= 0 columns only)
  conv:       'fft'    — zero-padded FFT2 (convolution theorem)
              'direct' — the direct sums, O(L^4) with a tiny constant (a
                         CUDA kernel pair; shift-and-add on the CPU)
              'rfft'   — half grids multiplied as real sphere samples
`GauntTensorProduct` is a thin wrapper over the engine's pairwise plans;
`gaunt_product_numpy` is the complex128 numpy oracle.

Layouts follow the reference ``repro.core.gaunt``: SH features
[..., (L+1)^2]; dense grids [..., 2L+1 (u), 2L+1 (v)]; half grids
[..., 2L+1 (u), L+1 (v >= 0)], all centered (index L <-> frequency 0).
The grid FFTs run on ``torch.fft`` (cuFFT on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from . import constants as _const
from .fourier import pack_hermitian, unpack_hermitian
from .rep import count_conversion
from .irreps import degree_slices, l_array, num_coeffs

__all__ = [
    "GauntTensorProduct",
    "sh_to_fourier",
    "fourier_to_sh",
    "sh_to_fourier_bydeg",
    "conv2d_full",
    "conv2d_herm",
    "gaunt_product_numpy",
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


def _packed_gather(L: int, device, dtype):
    gidx, mask = _const.pack_index(L)
    return (_const.to_torch(gidx, device, torch.int64),
            _const.to_torch(mask, device, dtype))


def sh_to_fourier(x: torch.Tensor, L: int, conversion: str = "dense",
                  cdtype=torch.complex64) -> torch.Tensor:
    """x [..., (L+1)^2] real -> centered grid: 'dense' and 'packed'
    [..., 2L+1, 2L+1], 'half' [..., 2L+1, L+1] (the v >= 0 columns).
    Ticks the 'sh_to_fourier' counter (`core.rep`)."""
    count_conversion("sh_to_fourier")
    if conversion != "packed":
        y = _conv_tensor(conversion, L, cdtype, x.device)
        return torch.einsum("...i,iuv->...uv", x.to(y.dtype), y)
    yp, yn = (_const.to_torch(a, x.device) for a in _const.y_packed(L, _CNAME[cdtype]))
    gidx, mask = _packed_gather(L, x.device, x.dtype)
    xb = (x[..., gidx] * mask).to(yp.dtype)  # [..., 2, L+1, L+1]
    # F columns for v = +mm and v = -mm
    fp = torch.einsum("...pml,mplu->...mu", xb, yp)  # [..., L+1 (mm), 2L+1 (u)]
    fn = torch.einsum("...pml,mplu->...mu", xb, yn)
    # the grid over v: [-L..-1] from fn (mm = -v), [0..L] from fp
    neg = torch.flip(fn[..., 1:, :], dims=(-2,))
    return torch.cat([neg, fp], dim=-2).transpose(-1, -2)


def fourier_to_sh(F: torch.Tensor, Lf: int, Lout: int, conversion: str = "dense",
                  rdtype=torch.float32) -> torch.Tensor:
    """Centered grid -> real irreps [..., (Lout+1)^2] ('dense' and 'packed'
    expect the full grid, 'half' the Hermitian half form).  Ticks the
    'fourier_to_sh' counter."""
    count_conversion("fourier_to_sh")
    cname = _CNAME[F.dtype]
    if conversion == "dense":
        z = _const.z_dense(Lf, Lout, cname)
    elif conversion == "half":
        z = _const.z_half(Lf, Lout, cname)
    elif conversion == "packed":
        return _fourier_to_sh_packed(F, Lf, Lout, cname, rdtype)
    else:
        raise ValueError(f"unknown conversion {conversion!r} "
                         "(expected 'dense'|'packed'|'half')")
    zt = _const.to_torch(z, F.device)
    return torch.einsum("...uv,uvk->...k", F, zt).real.to(rdtype)


def _fourier_to_sh_packed(F, Lf: int, Lout: int, cname: str, rdtype) -> torch.Tensor:
    zp, zn = (_const.to_torch(a, F.device) for a in _const.z_packed(Lf, Lout, cname))
    mmax = min(Lf, Lout)
    # columns v = +mm / v = -mm of the grid, mm = 0..Lout (zero rows if Lf < Lout)
    Ft = F.transpose(-1, -2)
    Fp = Ft[..., Lf: Lf + mmax + 1, :]                      # [..., mm, u]
    Fn = torch.flip(Ft[..., Lf - mmax: Lf + 1, :], dims=(-2,))
    if mmax < Lout:
        z = Fp.new_zeros(Fp.shape[:-2] + (Lout - mmax, Fp.shape[-1]))
        Fp, Fn = torch.cat([Fp, z], dim=-2), torch.cat([Fn, z], dim=-2)
    vals = (torch.einsum("...mu,mplu->...pml", Fp, zp)
            + torch.einsum("...mu,mplu->...pml", Fn, zn)).real.to(rdtype)
    gidx, mask = _packed_gather(Lout, F.device, rdtype)
    src = (vals * mask).reshape(vals.shape[:-3] + (-1,))
    out = src.new_zeros(vals.shape[:-3] + (num_coeffs(Lout),))
    return out.index_add(-1, gidx.reshape(-1), src)


def conv2d_full(F1: torch.Tensor, F2: torch.Tensor, method: str = "fft") -> torch.Tensor:
    """Full (linear) 2D convolution of centered coefficient grids.

    F1 [..., n1, n1], F2 [..., n2, n2] -> [..., n1+n2-1, n1+n2-1], centered.

    'direct' is `kernels.direct_conv.full_conv`: on CUDA tensors a
    hand-written kernel pair (forward, and one adjoint pass for both
    gradients) under one autograd Function, differentiable to any order;
    on CPU tensors its plain shift-and-add.  It replaces no TPU kernel (the
    reference's 'direct' is XLA's ``lax.conv_general_dilated``,
    ``repro/core/gaunt.py:131``).  The sums are bound by bytes: at the
    general conv's served shape (16 x 32 x 32 edges, 256 channels, 5 x 5
    (*) 7 x 7) the forward reads 0.85 GB and writes 4.06 GB, 1.46 ms at
    3.35 TB/s, against 0.61 ms of arithmetic; the kernels read each operand
    once and write each output once, and the filter grid shared by an
    edge's channels is read once a block and never expanded.
    """
    n1, n2 = F1.shape[-1], F2.shape[-1]
    N = n1 + n2 - 1
    if method == "fft":
        # zero-pad to N: linear convolution through the circular theorem
        G1 = torch.fft.fft2(F1, s=(N, N))
        G2 = torch.fft.fft2(F2, s=(N, N))
        return torch.fft.ifft2(G1 * G2)
    if method == "direct":
        from ..kernels.direct_conv import full_conv

        return full_conv(F1, F2)
    raise ValueError(f"unknown conv method {method!r}")


def sh_to_fourier_bydeg(x: torch.Tensor, L: int, conversion: str = "dense",
                        cdtype=torch.complex64) -> torch.Tensor:
    """Degree-resolved conversion: x [..., (L+1)^2] -> [..., L+1, n, nv].

    Slice l is the grid contribution of degree l alone, so any per-degree
    reweighting w . x converts as ``einsum('...l,...luv->...uv', w, Fl)`` —
    one conversion serves every reweighted copy of the same tensor (and
    ticks the 'sh_to_fourier' counter once)."""
    count_conversion("sh_to_fourier")
    y = _conv_tensor(conversion, L, cdtype, x.device)
    xc = x.to(y.dtype)
    parts = [torch.einsum("...i,iuv->...uv", xc[..., sl], y[sl])
             for sl in degree_slices(L)]
    return torch.stack(parts, dim=-3)


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


def conv2d_herm(F1h: torch.Tensor, F2h: torch.Tensor, method: str = "rfft") -> torch.Tensor:
    """Full 2D convolution of Hermitian half grids -> product half grid.

    F1h [..., 2L1+1, L1+1], F2h [..., 2L2+1, L2+1] -> [..., 2Lt+1, Lt+1],
    Lt = L1+L2.  method='rfft' multiplies the real spatial samples on an
    alias-free N x N grid and transforms back with `rfft2`; any other method
    unpacks to full grids, runs `conv2d_full`, and repacks.
    """
    L1 = (F1h.shape[-2] - 1) // 2
    L2 = (F2h.shape[-2] - 1) // 2
    Lt = L1 + L2
    if method != "rfft":
        full = conv2d_full(unpack_hermitian(F1h, L1), unpack_hermitian(F2h, L2), method)
        return pack_hermitian(full, Lt)
    N = 2 * Lt + 2
    s = _herm_spatial(F1h, L1, N) * _herm_spatial(F2h, L2, N)
    H = torch.fft.rfft2(s) / (N * N)
    return torch.cat([H[..., N - Lt:, : Lt + 1], H[..., : Lt + 1, : Lt + 1]], dim=-2)


# --------------------------------------------------------------------------
# the module
# --------------------------------------------------------------------------


class GauntTensorProduct:
    """Full Gaunt tensor product of irreps up to (L1, L2) -> degrees <= Lout.

    Equivariant Feature Interaction (paper §3.3): optional per-degree weights
    w1 [..., L1+1], w2 [..., L2+1], w3 [..., Lout+1] realize the
    w_{l1} w_{l2} w_l reparameterization.

    A thin wrapper over the engine's pairwise plans.  The reference's knobs
    map onto backends: (`conversion`='dense', `conv`='fft'|'direct') -> the
    'fft'/'direct' backends, 'packed' -> the 'packed' backend, 'half' -> the
    'rfft' backend.  `backend` overrides them ('auto' lets the engine
    choose; any registered name pins it).  ``device`` is the plan's device:
    None means cuda, and raises without a GPU (pass ``device="cpu"``).
    """

    def __init__(
        self,
        L1: int,
        L2: int,
        Lout: int | None = None,
        conversion: str = "dense",
        conv: str = "auto",
        cdtype=torch.complex64,
        rdtype=torch.float32,
        backend: str | None = None,
        batch_hint: int | None = None,
        tune: str = "heuristic",
        device=None,
    ):
        from . import engine as _engine  # lazy: the engine imports this module

        self.L1, self.L2 = L1, L2
        self.Lout = L1 + L2 if Lout is None else Lout
        self.conversion = conversion
        if conv == "auto":
            conv = "rfft" if conversion == "half" else _engine.spectral_default(L1, L2)
        self.conv = conv
        self.cdtype = cdtype
        self.rdtype = rdtype
        options = None
        if backend is None:
            if conversion == "dense":
                backend = self.conv  # 'fft' | 'direct'
            elif conversion == "packed":
                backend, options = "packed", {"conv": self.conv}
            elif conversion == "half":
                backend, options = "rfft", {"conv": self.conv}
            else:
                raise ValueError(f"unknown conversion {conversion!r}")
        elif backend == "auto":
            backend = None  # engine selection
        self._plan = _engine.plan(
            L1, L2, self.Lout, kind="pairwise", batch_hint=batch_hint,
            dtype=_engine._dtype_str(cdtype), backend=backend, options=options,
            tune=tune, device=device,
        )
        self.backend = self._plan.backend

    @property
    def plan(self):
        return self._plan

    def __call__(self, x1, x2, w1=None, w2=None, w3=None) -> torch.Tensor:
        return self._plan.apply(x1, x2, w1, w2, w3).to(self.rdtype)


# --------------------------------------------------------------------------
# numpy mirror (complex128) — the exactness oracle
# --------------------------------------------------------------------------


def gaunt_product_numpy(x1: np.ndarray, x2: np.ndarray, L1: int, L2: int,
                        Lout: int | None = None) -> np.ndarray:
    Lout = L1 + L2 if Lout is None else Lout
    y1 = _const._y_raw(L1)
    y2 = _const._y_raw(L2)
    z = _const._z_raw(L1 + L2, Lout)
    F1 = np.einsum("...i,iuv->...uv", x1.astype(np.float64), y1)
    F2 = np.einsum("...i,iuv->...uv", x2.astype(np.float64), y2)
    N = 2 * (L1 + L2) + 1
    G1 = np.fft.fft2(F1, s=(N, N))
    G2 = np.fft.fft2(F2, s=(N, N))
    F3 = np.fft.ifft2(G1 * G2)
    return np.einsum("...uv,uvk->...k", F3, z).real
