"""Equivariant many-body interactions (paper §3.3, class 3).

nu-fold Gaunt products  x_1 (x) ... (x) x_n.  The default route is one
engine chain plan (`engine.plan_chain`): on the spectral ``tree`` backend
every operand converts to its grid once and the grids combine by a
divide-and-conquer tree of 2D convolutions (depth ceil(log2 n), same-shaped
siblings in one batched call: the paper's parallelization); on the
collocation backends the whole product is one sample-multiply-project pass
(one kernel launch on ``fused_hopper``).  An explicit ``backend`` (or
``conversion='packed'``) takes the per-plan batched route instead
(`engine.plan_batch`, kind='manybody'), which converts every operand
through the plan's own boundary.
"""
from __future__ import annotations

import numpy as np
import torch

from .gaunt import conv2d_full, conv2d_herm

__all__ = ["manybody_gaunt_product", "manybody_selfmix"]


def _tree_convolve(grids: list, method: str, herm: bool = False):
    """Combine centered coefficient grids pairwise, level by level: full
    grids [..., n_i, n_i] by `conv2d_full`, or with ``herm`` Hermitian half
    grids [..., 2L_i+1, L_i+1] by `conv2d_herm`, each by ``method``
    ('fft' | 'direct', and 'rfft' for half grids).  Same-shaped sibling
    pairs stack into one batched convolution."""
    conv = conv2d_herm if herm else conv2d_full
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
                C = conv(torch.stack(As), torch.stack(Bs), method)
                nxt.extend(C.unbind(0))
                i = j
            else:
                nxt.append(conv(a, b, method))
                i += 2
        if i < len(grids):
            nxt.append(grids[i])
        grids = nxt
    return grids[0]


def manybody_gaunt_product(xs, Ls, Lout: int | None = None, weights=None,
                           conv: str | None = None, conversion: str | None = None,
                           cdtype=torch.complex64, rdtype=None,
                           backend: str | None = None, tune: str = "heuristic",
                           donate: bool = False, shard_spec=None,
                           out_basis: str = "sh", dtype=None, gate_params=None):
    """xs: list of [..., (L_i+1)^2] features (or Fourier-resident Reps);
    Ls: their max degrees; weights: optional per-operand per-degree weights
    [..., L_i+1].  Returns [..., (Lout+1)^2] (or a resident Rep for
    ``out_basis='fourier'``).

    ``dtype`` is the SH storage dtype ('float32' | 'bfloat16' | 'float64',
    or 'auto' with ``tune='measure'``); None means the dtype ``cdtype``
    implies (float32 for complex64).  ``rdtype=None`` returns the storage
    dtype, an explicit ``rdtype`` casts the SH output.

    The chain route (``backend=None`` and ``conversion`` None, 'dense' or
    'half'): one `engine.plan_chain` with ``conversion`` / ``conv`` (an
    explicit one pins the spectral 'tree' backend), ``tune='measure'``
    timing the chain backends at this call's row count (the product of the
    operands' leading dims) with duplicate operands measured as shared and
    the operands' and exit's bases as passed.  ``gate_params`` ({'w1',
    'w2'}) plans the models' gate as a chain-interior stage: the gated
    output equals ``gate_apply(gate_params, product)``.

    ``backend`` (a registered name, or 'auto' for the engine's pick) or
    ``conversion='packed'`` takes the batched kind='manybody' route.
    ``donate`` is accepted and donates nothing.  ``shard_spec``
    (`engine.ShardSpec`) stays on either route: the chain, or the batched
    bucket, splits its rows over the mesh's data-parallel ranks.  The
    operands' device is the plans' device.
    """
    from . import engine as _engine

    if len(xs) != len(Ls) or len(xs) < 2:
        raise ValueError(f"chain needs >= 2 operands matching Ls, got {len(xs)} / {Ls}")
    if dtype is None:
        dts = _engine._dtype_str(cdtype)
    else:
        dts = "auto" if dtype == "auto" else _engine._dtype_str(dtype)

    def _data(x):
        return x.data if hasattr(x, "basis") else x

    device = _data(xs[0]).device
    if backend is None and conversion in (None, "dense", "half"):
        hint = entry = share = None
        if tune == "measure":
            lead = torch.broadcast_shapes(*[
                (_data(x).shape[:-2] if getattr(x, "is_fourier", False) else _data(x).shape[:-1])
                for x in xs])
            hint = int(np.prod(lead)) if lead else 1
            # time on the operand kinds passed: resident Reps stay resident,
            # and duplicate operands repeat one synthetic buffer
            entry = tuple("fourier" if getattr(x, "is_fourier", False) else "sh" for x in xs)
            seen: dict = {}
            share = tuple(seen.setdefault(id(_data(x)), len(seen)) for x in xs)
        cp = _engine.plan_chain(Ls, Lout, conversion=conversion, conv=conv, dtype=dts,
                                donate=donate, shard_spec=shard_spec, tune=tune,
                                batch_hint=hint, entry_hint=entry,
                                out_hint=out_basis, share_hint=share,
                                gate=gate_params is not None, device=device)
        out = cp.apply(list(xs), weights=weights, out_basis=out_basis,
                       gate_params=gate_params)
        if out_basis == "fourier" or rdtype is None:
            return out
        return out.to(rdtype)
    if gate_params is not None:
        raise ValueError("gate_params requires the chain route "
                         "(no explicit backend/conversion override)")
    if out_basis != "sh":
        raise ValueError("out_basis='fourier' requires the chain route "
                         "(no explicit backend/conversion override)")
    options = None
    if backend == "auto":
        backend = None
    elif backend is None:
        if conversion == "packed":
            backend, options = "packed", {"conv": conv or "fft"}
        else:
            raise ValueError(f"unknown conversion {conversion!r}")
    item = _engine.BatchItem(Ls=tuple(int(L) for L in Ls), Lout=Lout,
                             options=tuple(sorted((options or {}).items())))
    bp = _engine.plan_batch([item], kind="manybody", dtype=dts, backend=backend,
                            tune=tune, donate=donate, shard_spec=shard_spec, device=device)
    out = bp.apply([list(xs)], weights=[weights])[0]
    return out if rdtype is None else out.to(rdtype)


def manybody_selfmix(x, L: int, nu: int, Lout: int | None = None, weights=None, **kw):
    """MACE-style B_nu = A (x) ... (x) A (nu operands of the same tensor):
    on the chain route A converts to the Fourier basis once (degree-resolved
    when the per-operand weights differ)."""
    return manybody_gaunt_product([x] * nu, [L] * nu, Lout=Lout, weights=weights, **kw)
