"""Basis-tagged representations: a minimal port of the reference ``Rep``.

A Rep carries ``data`` with its basis and storage form:
  basis 'sh'      — packed real irreps [..., (L+1)^2]
        'fourier' — centered torus-coefficient grid, form 'dense'
                    [..., 2L+1, 2L+1] or 'half' [..., 2L+1, L+1]
Chain plans accept Fourier-resident Reps as operands (their conversion is
skipped) and can return the product resident.  Conversion counters and the
quadrature basis are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from .irreps import num_coeffs

__all__ = ["Rep"]


@dataclasses.dataclass(frozen=True)
class Rep:
    data: torch.Tensor
    L: int
    basis: str = "sh"
    form: str = "dense"

    def __post_init__(self):
        if self.basis not in ("sh", "fourier"):
            raise ValueError(f"unknown basis {self.basis!r}")
        if self.basis == "fourier" and self.form not in ("dense", "half"):
            raise ValueError(f"unknown fourier form {self.form!r}")

    @classmethod
    def from_sh(cls, x: torch.Tensor, L: int) -> "Rep":
        if x.shape[-1] != num_coeffs(L):
            raise ValueError(f"sh data last dim {x.shape[-1]} != (L+1)^2 = {num_coeffs(L)}")
        return cls(x, L, "sh")

    @property
    def is_fourier(self) -> bool:
        return self.basis == "fourier"

    def to_fourier(self, conversion: str = "half") -> "Rep":
        """-> Fourier-resident Rep ('dense' or 'half' grid)."""
        from .gaunt import sh_to_fourier

        if self.is_fourier:
            return self.with_form(conversion)
        return Rep(sh_to_fourier(self.data, self.L, conversion), self.L, "fourier",
                   conversion)

    def with_form(self, form: str) -> "Rep":
        """Change the Fourier storage form (lossless for real functions)."""
        from .gaunt import unpack_hermitian

        if not self.is_fourier:
            raise ValueError("with_form applies to Fourier-resident Reps")
        if form == self.form:
            return self
        if form == "half":
            return Rep(self.data[..., self.L:], self.L, "fourier", "half")
        if form == "dense":
            return Rep(unpack_hermitian(self.data, self.L), self.L, "fourier", "dense")
        raise ValueError(f"unknown fourier form {form!r}")
