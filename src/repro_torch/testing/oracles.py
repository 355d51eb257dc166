"""Numeric oracles for the port's tests, the reference's
(``repro.testing.oracles``) on the port's own exact SO(3) code
(`repro_torch.core.so3`): numpy float64 throughout, so no fast path under
test verifies itself.

* random irreps, directions and rotations with explicit seeds;
* Wigner-D helpers: the packed block-diagonal rotation of irrep features;
* reference products: the dense real-Gaunt einsum and the per-path CG fold.
"""
from __future__ import annotations

import numpy as np

from ..core.irreps import num_coeffs
from ..core.so3 import (
    real_clebsch_gordan_block,
    real_gaunt_tensor,
    rotation_matrix_zyz,
    wigner_D_real_packed,
)

__all__ = [
    "random_array",
    "random_irreps",
    "random_unit_vectors",
    "random_angles",
    "rotation_matrix",
    "wigner_D",
    "rotate_irreps",
    "gaunt_product_oracle",
    "cg_product_oracle",
]


def random_array(shape, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """A standard-normal array with an explicit seed."""
    return np.random.default_rng(seed).normal(size=tuple(shape)).astype(dtype)


def random_irreps(L: int, lead=(), seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Random packed irrep features [..., (L+1)^2] (standard normal)."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=tuple(lead) + (num_coeffs(L),)).astype(dtype)


def random_unit_vectors(lead=(), seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Uniformly distributed unit vectors [..., 3]."""
    v = np.random.default_rng(seed).normal(size=tuple(lead) + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(dtype)


def random_angles(seed: int = 0) -> tuple[float, float, float]:
    """Random zyz Euler angles (alpha, gamma in [0, 2pi); beta in (0, pi))."""
    rng = np.random.default_rng(seed)
    return (float(rng.uniform(0, 2 * np.pi)), float(rng.uniform(0.05, np.pi - 0.05)),
            float(rng.uniform(0, 2 * np.pi)))


def rotation_matrix(angles) -> np.ndarray:
    """R = Rz(alpha) Ry(beta) Rz(gamma) [3, 3]."""
    return rotation_matrix_zyz(*angles)


def wigner_D(L: int, angles, dtype=np.float32) -> np.ndarray:
    """The block-diagonal real Wigner-D over the packed (L+1)^2 layout, with
    S^l(R r) = D S^l(r) for R = rotation_matrix(angles)."""
    return wigner_D_real_packed(L, *angles).astype(dtype)


def rotate_irreps(x, L: int, angles) -> np.ndarray:
    """Apply the packed Wigner-D of ``angles`` to the last axis of x."""
    D = wigner_D(L, angles, dtype=np.float64)
    return (np.asarray(x, np.float64) @ D.T).astype(np.asarray(x).dtype)


def gaunt_product_oracle(x1, x2, L1: int, L2: int, Lout: int | None = None) -> np.ndarray:
    """The dense float64 einsum with the exact real Gaunt tensor."""
    Lout = L1 + L2 if Lout is None else Lout
    G = real_gaunt_tensor(L1, L2, Lout)
    return np.einsum("...i,...j,ijk->...k", np.asarray(x1, np.float64),
                     np.asarray(x2, np.float64), G)


def cg_product_oracle(x1, x2, L1: int, L2: int, Lout: int | None = None) -> np.ndarray:
    """The per-path Clebsch-Gordan fold (e3nn-style full TP), float64."""
    Lout = L1 + L2 if Lout is None else Lout
    x1, x2 = np.asarray(x1, np.float64), np.asarray(x2, np.float64)
    out = np.zeros(np.broadcast_shapes(x1.shape[:-1], x2.shape[:-1]) + (num_coeffs(Lout),))
    for l1 in range(L1 + 1):
        for l2 in range(L2 + 1):
            for l3 in range(abs(l1 - l2), min(Lout, l1 + l2) + 1):
                C = real_clebsch_gordan_block(l1, l2, l3)
                out[..., l3 * l3:(l3 + 1) ** 2] += np.einsum(
                    "...i,...j,ijk->...k", x1[..., l1 * l1:(l1 + 1) ** 2],
                    x2[..., l2 * l2:(l2 + 1) ** 2], C)
    return out
