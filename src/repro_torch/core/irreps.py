"""Irrep metadata and packed-layout utilities (numpy).

Features holding all irreps of degree 0..L (one copy each) are packed into a
single vector of dimension (L+1)^2 using the index map  idx(l, m) = l^2 + l + m
with -l <= m <= l.  Every op of the port keeps this packed irrep axis last.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = [
    "num_coeffs",
    "idx",
    "lm_of_index",
    "degree_slices",
    "l_array",
    "m_array",
    "Irreps",
]


def num_coeffs(L: int) -> int:
    """Dimension of a packed feature with degrees 0..L."""
    return (L + 1) ** 2


def idx(l: int, m: int) -> int:
    """Flat index of (l, m) in the packed layout."""
    if not (-l <= m <= l):
        raise ValueError(f"invalid order m={m} for degree l={l}")
    return l * l + l + m


@lru_cache(maxsize=None)
def lm_of_index(L: int) -> tuple[np.ndarray, np.ndarray]:
    """Arrays (l_of_idx, m_of_idx), each of shape [(L+1)^2]."""
    ls = np.concatenate([np.full(2 * l + 1, l, dtype=np.int32) for l in range(L + 1)])
    ms = np.concatenate([np.arange(-l, l + 1, dtype=np.int32) for l in range(L + 1)])
    return ls, ms


def l_array(L: int) -> np.ndarray:
    return lm_of_index(L)[0]


def m_array(L: int) -> np.ndarray:
    return lm_of_index(L)[1]


def degree_slices(L: int) -> list[slice]:
    """slice of the packed axis occupied by each degree l = 0..L."""
    return [slice(l * l, (l + 1) * (l + 1)) for l in range(L + 1)]


@dataclasses.dataclass(frozen=True)
class Irreps:
    """A contiguous stack of irreps 0..L with C channels.

    This is deliberately simpler than e3nn's Irreps: the Gaunt tensor product
    operates on 'full' features (every degree present once per channel), which
    is also what SEGNN / MACE / EquiformerV2 style models use in practice.
    Parity is implicit: degree-l components carry spherical-harmonic parity
    (-1)^l (see DESIGN.md — the Gaunt product lives in this subspace).
    """

    L: int
    channels: int = 1

    @property
    def dim(self) -> int:
        return num_coeffs(self.L)

    def empty(self, *lead: int, dtype=np.float32) -> np.ndarray:
        return np.zeros((*lead, self.channels, self.dim), dtype=dtype)

    def slice_of(self, l: int) -> slice:
        if l > self.L:
            raise ValueError(f"degree {l} > max degree {self.L}")
        return slice(l * l, (l + 1) * (l + 1))

    def __str__(self) -> str:  # e3nn-ish display
        return "+".join(f"{self.channels}x{l}" for l in range(self.L + 1))
