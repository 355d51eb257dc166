"""Clebsch-Gordan tensor products — the paper's O(L^6) baseline (e3nn-style),
and the dense real-Gaunt einsum that is the oracle for every fast Gaunt
path of the port.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from . import constants as _const
from .constants import gaunt_dense as gaunt_dense_tensor  # the cached exact tensor
from .so3 import real_clebsch_gordan_block

__all__ = [
    "cg_full_tensor_product",
    "gaunt_einsum_reference",
    "gaunt_dense_tensor",
    "gaunt_dense_tensor_torch",
]


@lru_cache(maxsize=None)
def _cg_paths(L1: int, L2: int, Lout: int):
    """All (l1, l2, l3) paths with their real CG blocks (numpy)."""
    paths = []
    for l1 in range(L1 + 1):
        for l2 in range(L2 + 1):
            for l3 in range(abs(l1 - l2), min(Lout, l1 + l2) + 1):
                paths.append((l1, l2, l3, real_clebsch_gordan_block(l1, l2, l3)))
    return paths


def cg_full_tensor_product(x1: torch.Tensor, x2: torch.Tensor, L1: int, L2: int,
                           Lout: int | None = None, weights=None) -> torch.Tensor:
    """e3nn-style full CG tensor product over all (l1, l2) -> l3 paths.

    x1 [..., (L1+1)^2], x2 [..., (L2+1)^2] -> [..., (Lout+1)^2].
    weights: optional dict (l1, l2, l3) -> scalar (or [...]-broadcastable).
    The baseline the paper benchmarks against (Fig. 1): one 3D contraction
    per path, O(L^6) in all.
    """
    Lout = L1 + L2 if Lout is None else Lout
    lead = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
    blocks: list = [None] * (Lout + 1)
    for l1, l2, l3, C in _cg_paths(L1, L2, Lout):
        xa = x1[..., l1 * l1: (l1 + 1) ** 2]
        xb = x2[..., l2 * l2: (l2 + 1) ** 2]
        Ct = _const.to_torch(C, x1.device, x1.dtype)
        n1, n2, n3 = C.shape
        # sum_ij xa_i xb_j C_ijk, one operand at a time
        t = (xa @ Ct.reshape(n1, n2 * n3)).reshape(*xa.shape[:-1], n2, n3)
        blk = (xb.unsqueeze(-2) @ t).squeeze(-2)
        if weights is not None:
            blk = blk * weights[(l1, l2, l3)]
        blocks[l3] = blk if blocks[l3] is None else blocks[l3] + blk
    out = [b.expand(*lead, 2 * l + 1) if b is not None
           else x1.new_zeros(*lead, 2 * l + 1) for l, b in enumerate(blocks)]
    return torch.cat(out, dim=-1)


# The reference's ``gaunt_dense_tensor_jnp`` under the port's name; it
# returns the cached numpy array, which torch callers wrap themselves.
gaunt_dense_tensor_torch = gaunt_dense_tensor


def gaunt_einsum_reference(x1: torch.Tensor, x2: torch.Tensor, L1: int, L2: int,
                           Lout: int | None = None) -> torch.Tensor:
    """Dense einsum with the exact real Gaunt tensor — the correctness oracle
    (O(L^6) like the CG baseline, different coefficients)."""
    Lout = L1 + L2 if Lout is None else Lout
    G = _const.to_torch(gaunt_dense_tensor(L1, L2, Lout, str(x1.dtype)[6:]), x1.device)
    return torch.einsum("...i,...j,ijk->...k", x1, x2, G)
