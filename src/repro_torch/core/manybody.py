"""Equivariant many-body interactions (paper §3.3, class 3): the chain route.

nu-fold Gaunt products  x_1 (x) ... (x) x_n  run as one engine chain plan
(`engine.plan_chain`): on the spectral ``tree`` backend every operand
converts to its half grid once and the grids combine by a divide-and-conquer
tree of 2D convolutions; on the collocation backends the whole product is
one sample-multiply-project pass (one kernel launch on ``fused_hopper``).
"""
from __future__ import annotations

import numpy as np
import torch

from .gaunt import conv2d_herm

__all__ = ["manybody_gaunt_product", "manybody_selfmix"]


def _tree_convolve(grids: list):
    """Combine centered half grids [..., 2L_i+1, L_i+1] pairwise, level by
    level; same-shaped sibling pairs stack into one batched convolution."""
    while len(grids) > 1:
        nxt = []
        i = 0
        while i + 1 < len(grids):
            a, b = grids[i], grids[i + 1]
            if a.shape == b.shape and len(grids) >= 4:
                j = i
                As, Bs = [], []
                while (j + 1 < len(grids) and grids[j].shape == a.shape
                       and grids[j + 1].shape == b.shape):
                    As.append(grids[j])
                    Bs.append(grids[j + 1])
                    j += 2
                C = conv2d_herm(torch.stack(As), torch.stack(Bs))
                nxt.extend(C.unbind(0))
                i = j
            else:
                nxt.append(conv2d_herm(a, b))
                i += 2
        if i < len(grids):
            nxt.append(grids[i])
        grids = nxt
    return grids[0]


def manybody_gaunt_product(xs, Ls, Lout: int | None = None, weights=None, *,
                           tune: str = "heuristic", dtype="float32",
                           out_basis: str = "sh", gate_params=None):
    """xs: list of [..., (L_i+1)^2] features (or Fourier-resident Reps);
    Ls: their max degrees; weights: optional per-operand per-degree weights
    [..., L_i+1].  Returns [..., (Lout+1)^2] (or a resident Rep for
    ``out_basis='fourier'``).

    ``tune='measure'`` lets the engine time the chain backends at this
    call's row count (the product of the operands' leading dims), with
    duplicate operands measured as shared.  ``gate_params`` ({'w1', 'w2'})
    plans the models' gate as a chain-interior stage: the gated output
    equals ``gate_apply(gate_params, product)``.
    """
    from . import engine as _engine

    if len(xs) != len(Ls) or len(xs) < 2:
        raise ValueError(f"chain needs >= 2 operands matching Ls, got {len(xs)} / {Ls}")

    def _data(x):
        return x.data if hasattr(x, "basis") else x

    hint = share = None
    if tune == "measure":
        lead = torch.broadcast_shapes(*[
            (_data(x).shape[:-2] if getattr(x, "is_fourier", False) else _data(x).shape[:-1])
            for x in xs])
        hint = int(np.prod(lead)) if lead else 1
        seen: dict = {}
        share = tuple(seen.setdefault(id(_data(x)), len(seen)) for x in xs)
    cp = _engine.plan_chain(Ls, Lout, dtype=dtype, tune=tune, batch_hint=hint,
                            share_hint=share, gate=gate_params is not None,
                            device=_data(xs[0]).device)
    return cp.apply(list(xs), weights=weights, out_basis=out_basis,
                    gate_params=gate_params)


def manybody_selfmix(x, L: int, nu: int, Lout: int | None = None, weights=None, **kw):
    """MACE-style B_nu = A (x) ... (x) A (nu operands of the same tensor)."""
    return manybody_gaunt_product([x] * nu, [L] * nu, Lout=Lout, weights=weights, **kw)
