"""Basis-tagged representations: Fourier- and quadrature-resident
activations (the reference's ``repro.core.rep``).

The Gaunt pipeline's cost at practical L is in the SH <-> Fourier
conversions, not in the 2D convolution.  `Rep` makes the basis a property
of an activation, so consumers (chain plans, pairwise plans with Fourier
boundaries, the models) keep tensors resident across consecutive products
and project back to SH only where the math demands it (per-degree weights,
gates, degree-wise channel mixing).

A Rep carries:
  basis : 'sh'      — ``data`` is the packed real irrep vector [..., (L+1)^2]
          'fourier' — ``data`` is the centered torus-coefficient grid
          'quad'    — ``data`` holds real samples on the S^2 quadrature grid
                      [..., n_theta, n_phi] (form 'grid')
  form  : fourier storage: 'dense' [..., 2L+1, 2L+1] complex, or 'half'
          (Hermitian) [..., 2L+1, L+1], the v >= 0 columns
  L     : the bandlimit
  sdtype: the SH-side storage dtype tag ('float32' | 'bfloat16' |
          'float64', None = untagged -> float32): grids are complex, so the
          tag is how a bf16 activation keeps its storage across a round trip

This module also holds the conversion counters.  Every ``sh_to_fourier``,
``fourier_to_sh`` and ``sh_to_fourier_bydeg`` (`core.gaunt`) and every
quadrature leg here ticks one, which is how the tests prove that chain
plans and resident filters elide conversions.  The port runs eagerly, so a
counter ticks once per call; the reference ticks once per jit trace, and
on eager calls the two agree (tested).  A served bucket's CUDA graph ticks
once per replay (`add_conversions`), not at its capture.  ``with
conversion_stats(fresh=True) as c:`` scopes a count (snapshot and restore).
"""
from __future__ import annotations

import dataclasses

import torch

from . import fourier as _fx
from .irreps import num_coeffs

__all__ = [
    "Rep",
    "ConversionStats",
    "count_conversion",
    "add_conversions",
    "conversion_stats",
    "reset_conversion_stats",
]


# --------------------------------------------------------------------------
# conversion counters
# --------------------------------------------------------------------------

_COUNTS = {"sh_to_fourier": 0, "fourier_to_sh": 0,
           "sh_to_quad": 0, "quad_to_sh": 0,
           "fourier_to_quad": 0, "quad_to_fourier": 0}


def count_conversion(name: str) -> None:
    """Record one basis conversion (called at every conversion call)."""
    _COUNTS[name] += 1


def add_conversions(counts: dict) -> None:
    """Add conversions no call ticked itself: a CUDA graph's replay runs
    again every conversion captured in it, and its capture ran none (the
    counterpart of `kernels.gaunt_fused.add_kernel_launches`)."""
    for k, v in counts.items():
        _COUNTS[k] += v


class ConversionStats(dict):
    """A snapshot of the conversion counters, and a scoped counting context.

    ``with conversion_stats(fresh=True) as c: run()`` — on entry the module
    counters are snapshotted and zeroed; on exit ``c`` holds the
    conversions that ran inside the block and the module counters are
    restored to snapshot + delta (an outer block includes a nested block's
    count).  ``fresh`` is accepted for the reference's API: it drops warm
    jit caches there, and the port has none (every call converts anew).
    """

    def __init__(self, data, fresh: bool = False):
        super().__init__(data)
        self._fresh = fresh
        self._snap = None

    def __enter__(self) -> "ConversionStats":
        self._snap = dict(_COUNTS)
        for k in _COUNTS:
            _COUNTS[k] = 0
        self.clear()
        self.update({k: 0 for k in self._snap})
        return self

    def __exit__(self, *exc) -> bool:
        delta = dict(_COUNTS)
        self.clear()
        self.update(delta)
        for k in _COUNTS:
            _COUNTS[k] = self._snap[k] + delta[k]
        return False


def conversion_stats(fresh: bool = False) -> ConversionStats:
    """The counters since the last reset, and a context manager for a
    scoped count (see `ConversionStats`)."""
    return ConversionStats(_COUNTS, fresh=fresh)


def reset_conversion_stats() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


# --------------------------------------------------------------------------
# the Rep type
# --------------------------------------------------------------------------

_TAGS = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float64: "float64"}


def _complex_for(tag: str | None):
    return torch.complex128 if tag == "float64" else torch.complex64


@dataclasses.dataclass(frozen=True)
class Rep:
    """A degree-L equivariant activation tagged with its basis (see the
    module docstring).  Enter the quadrature grid with ``to_quad(os)``
    from either basis, apply value-space functions with
    ``apply_pointwise``, leave with ``to_sh`` / ``to_fourier``; each leg
    ticks its own counter."""

    data: torch.Tensor
    L: int
    basis: str = "sh"
    form: str = "dense"
    sdtype: str | None = None

    def __post_init__(self):
        if self.basis not in ("sh", "fourier", "quad"):
            raise ValueError(f"unknown basis {self.basis!r}")
        if self.basis == "fourier" and self.form not in ("dense", "half"):
            raise ValueError(f"unknown fourier form {self.form!r}")
        if self.basis == "quad" and self.form != "grid":
            raise ValueError(f"quad basis stores real samples (form='grid'), "
                             f"got form={self.form!r}")

    # -- constructors ------------------------------------------------------

    @staticmethod
    def _tag(x) -> str | None:
        return _TAGS.get(x.dtype)

    @classmethod
    def from_sh(cls, x: torch.Tensor, L: int) -> "Rep":
        if x.shape[-1] != num_coeffs(L):
            raise ValueError(f"sh data last dim {x.shape[-1]} != (L+1)^2 = {num_coeffs(L)}")
        return cls(x, L, "sh", sdtype=cls._tag(x))

    @classmethod
    def from_fourier(cls, F: torch.Tensor, L: int, form: str = "dense") -> "Rep":
        n = 2 * L + 1
        want = (n, n) if form == "dense" else (n, L + 1)
        if tuple(F.shape[-2:]) != want:
            raise ValueError(f"fourier data trailing dims {tuple(F.shape[-2:])} != {want} "
                             f"for L={L}, form={form!r}")
        return cls(F, L, "fourier", form)

    # -- basis / form changes ---------------------------------------------

    def to_fourier(self, conversion: str = "dense", cdtype=None,
                   form: str | None = None) -> "Rep":
        """-> Fourier-resident Rep (only a form change when already there).

        ``conversion`` is the SH -> Fourier realization ('dense' | 'packed'
        | 'half'); ``form`` the resident storage (default 'half' for
        conversion='half', else 'dense').  ``cdtype=None`` follows the tag:
        float64 -> complex128, float32/bfloat16 -> complex64."""
        from . import constants as _c
        from .gaunt import sh_to_fourier

        if form is None:
            form = "half" if conversion == "half" else "dense"
        if self.basis == "fourier":
            return self.with_form(form)
        tag = self.sdtype or self._tag(self.data)
        cdtype = _complex_for(tag) if cdtype is None else cdtype
        if self.basis == "quad":
            nt, nph = self.data.shape[-2:]
            cname = "complex128" if cdtype == torch.complex128 else "complex64"
            Pf = _c.to_torch(_c.quad_project_fourier(self.L, nt, nph, cname), self.data.device)
            count_conversion("quad_to_fourier")
            rdt = torch.float64 if cdtype == torch.complex128 else torch.float32
            V = self.data.reshape(*self.data.shape[:-2], -1).to(rdt).to(cdtype)
            F = torch.einsum("...g,guv->...uv", V, Pf)
            return Rep(F, self.L, "fourier", "half", sdtype=tag).with_form(form)
        F = sh_to_fourier(self.data, self.L, conversion, cdtype)
        got = "half" if conversion == "half" else "dense"
        return Rep(F, self.L, "fourier", got, sdtype=tag).with_form(form)

    def to_sh(self, Lout: int | None = None, rdtype=None) -> "Rep":
        """Project to SH degrees <= Lout (default: the bandlimit).
        ``rdtype=None`` exits at the carried storage tag (float32 when
        untagged)."""
        from . import constants as _c
        from .gaunt import fourier_to_sh

        if rdtype is None:
            rdtype = getattr(torch, self.sdtype or "float32")
        elif isinstance(rdtype, str):
            rdtype = getattr(torch, rdtype)
        Lout = self.L if Lout is None else Lout
        if self.basis == "sh":
            if Lout > self.L:
                raise ValueError(f"cannot raise SH degree {self.L} -> {Lout}")
            x = self.data if Lout == self.L else self.data[..., : num_coeffs(Lout)]
            return Rep(x, Lout, "sh", sdtype=self.sdtype)
        if self.basis == "quad":
            if Lout > self.L:
                raise ValueError(f"cannot raise SH degree {self.L} -> {Lout}")
            nt, nph = self.data.shape[-2:]
            f64 = self.data.dtype == torch.float64
            P = _c.to_torch(_c.quad_project_sh(Lout, nt, nph, "float64" if f64 else "float32"),
                            self.data.device)
            count_conversion("quad_to_sh")
            V = self.data.reshape(*self.data.shape[:-2], -1)
            x = (V.to(P.dtype) @ P).to(rdtype)
            return Rep(x, Lout, "sh", sdtype=self._tag(x))
        conv = "half" if self.form == "half" else "dense"
        x = fourier_to_sh(self.data, self.L, Lout, conv, rdtype)
        return Rep(x, Lout, "sh", sdtype=self._tag(x))

    def to_quad(self, os: int = 2, n_theta: int | None = None,
                n_phi: int | None = None) -> "Rep":
        """-> real samples on the S^2 quadrature grid.  The default ``os=2``
        sizes the grid exact through degree 4L+3: enough to project a
        squared degree-2L signal, or an affine gate of it, without
        aliasing.  ``n_theta`` / ``n_phi`` override the sized grid."""
        from . import constants as _c

        nt, nph = _fx.s2quad_size(self.L, os)
        if n_theta is not None:
            nt = int(n_theta)
        if n_phi is not None:
            nph = int(n_phi)
        if self.basis == "quad":
            if tuple(self.data.shape[-2:]) != (nt, nph):
                raise ValueError(
                    f"quad Rep already on a {tuple(self.data.shape[-2:])} grid; "
                    f"resampling to ({nt}, {nph}) is not supported — exit via "
                    f"to_sh()/to_fourier() first")
            return self
        tag = self.sdtype or self._tag(self.data)
        rname = "float64" if tag == "float64" else "float32"
        rdt = getattr(torch, rname)
        dev = self.data.device
        if self.basis == "sh":
            A = _c.to_torch(_c.quad_sample_sh(self.L, nt, nph, rname), dev)
            count_conversion("sh_to_quad")
            V = self.data.to(rdt) @ A
        else:
            E = _c.to_torch(_c.quad_sample_fourier(self.L, nt, nph, rname), dev)
            count_conversion("fourier_to_quad")
            F = self.with_form("half").data
            FR = torch.cat([F.real.reshape(*F.shape[:-2], -1),
                            F.imag.reshape(*F.shape[:-2], -1)], dim=-1)
            V = FR.to(rdt) @ E
        V = V.reshape(*V.shape[:-1], nt, nph)
        return Rep(V, self.L, "quad", "grid", sdtype=tag)

    def apply_pointwise(self, fn) -> "Rep":
        """Apply a value-space function sample by sample (quad Reps only)."""
        if self.basis != "quad":
            raise ValueError("apply_pointwise requires a quadrature-grid "
                             "Rep; enter with to_quad() first")
        return dataclasses.replace(self, data=fn(self.data))

    def with_form(self, form: str) -> "Rep":
        """Change the Fourier storage form (Hermitian pack/unpack, lossless
        for real functions); other bases come back unchanged."""
        from .gaunt import unpack_hermitian

        if self.basis != "fourier" or form == self.form:
            return self
        if form == "half":
            return Rep(_fx.pack_hermitian(self.data, self.L), self.L, "fourier", "half",
                       sdtype=self.sdtype)
        if form == "dense":
            return Rep(unpack_hermitian(self.data, self.L), self.L, "fourier", "dense",
                       sdtype=self.sdtype)
        raise ValueError(f"unknown fourier form {form!r}")

    def resize(self, L_new: int) -> "Rep":
        """Change the grid bandlimit in the basis (padding is exact;
        truncation assumes the content is bandlimited at ``L_new``)."""
        if self.basis != "fourier":
            raise ValueError("resize is a Fourier-grid op; project SH Reps "
                             "with to_sh(Lout) instead")
        fn = _fx.grid_resize_half if self.form == "half" else _fx.grid_resize
        return Rep(fn(self.data, self.L, L_new), L_new, "fourier", self.form,
                   sdtype=self.sdtype)

    def grid(self, form: str = "dense") -> torch.Tensor:
        """The raw coefficient grid in the requested form (fourier Reps)."""
        if self.basis != "fourier":
            raise ValueError("grid() requires a Fourier-resident Rep")
        return self.with_form(form).data

    # -- conveniences ------------------------------------------------------

    @property
    def is_fourier(self) -> bool:
        return self.basis == "fourier"

    def astype(self, dtype) -> "Rep":
        data = self.data.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)
        tag = self._tag(data) if self.basis in ("sh", "quad") else self.sdtype
        return dataclasses.replace(self, data=data, sdtype=tag)

    def __add__(self, other: "Rep") -> "Rep":
        """Linear combination inside one basis (residuals on residents)."""
        if not isinstance(other, Rep):
            return NotImplemented
        if (self.basis, self.L) != (other.basis, other.L):
            raise ValueError(f"cannot add Rep(basis={self.basis}, L={self.L}) and "
                             f"Rep(basis={other.basis}, L={other.L})")
        o = other.with_form(self.form) if self.basis == "fourier" else other
        return dataclasses.replace(self, data=self.data + o.data)
