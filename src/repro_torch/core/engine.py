"""The Gaunt engine: one plan/dispatch layer over the realizations of the
Gaunt tensor product (the reference's ``repro.core.engine``).

Pairwise plans (``plan``):

    p   = plan(L1, L2, Lout, kind="pairwise", batch_hint=4096)
    out = p.apply(x1, x2, w1=w1)        # the paper's w_{l1} w_{l2} w_l hooks

    kind         backends
    pairwise     dense_einsum | fft | direct | packed | rfft | fused_torch | fused_hopper
    conv_filter  escn_aligned + every pairwise backend (filter materialized)
    manybody     dense_einsum | fft | direct | packed | rfft
    channel_mix  dense_einsum | fused_torch

``kind='manybody'`` takes the operands' degrees ``Ls`` instead of L1/L2 and
applies to a list of operands: ``plan(kind='manybody', Ls=(2, 2, 2),
Lout=2).apply([x1, x2, x3], weights=None)``.  It is the per-plan batched
route of `manybody_gaunt_product` (an explicit ``backend``, or
``conversion='packed'``); its default route is a chain plan.  The fused
backends do not list the kind: the chain plans are their many-body path.

A plan is keyed by `PlanKey` ``(L1, L2, Lout, kind, batch_hint, dtype,
options, device)`` and resolved to a registered `Backend`, by the
reference's cost model (``tune='heuristic'``) or by timing the eligible
backends on the plan's device (``tune='measure'``).  ``fused_torch`` and
``fused_hopper`` are the reference's ``fused_xla`` and ``fused_pallas``:
the collocation product in torch ops and on the hand-written sm_90a kernel
(`kernels.gaunt_fused.gaunt_fused_hopper`, no gradient).

The spectral pairwise backends (fft, direct, packed, rfft) take
Fourier-resident operands and can return a resident product:
``options={'boundary': ('sh'|'fourier',) * 3}`` (x1, x2, out).

Batched plans (``plan_batch``): items that share a degree signature form a
bucket, and each bucket is one call on its inner plan over the
concatenated, tail-padded rows; per-item outputs are sliced back.

Chain plans (``plan_chain``), the main path's many-body stage:

* ``tree`` — the resident spectral pass: each distinct operand converts to
  a grid once (degree-resolved when the same tensor enters under different
  per-degree weights), the grids combine by a divide-and-conquer tree of 2D
  convolutions (``tree=False``: the sequential left fold), and one
  projection runs at the exit.  ``conversion`` picks Hermitian half grids
  ('half', the default) or dense ones, ``conv`` the grid combination:
  'rfft' (half grids only), 'fft' or 'direct'; by default 'direct' for a
  2-operand chain of max degree <= 4 and 'rfft' otherwise, as in the
  reference.
* ``looped`` — the pre-residency left fold of pairwise spectral plans, a
  full SH round trip per product (a measured candidate, so the autotuner
  prices what residency buys).
* ``fused_torch`` — the n-way collocation product in plain torch ops.
* ``fused_hopper`` — the same product on the chain kernel
  (`kernels.gaunt_fused.gaunt_chain_fused_hopper`).

``plan_chain(tune='measure')`` times the candidates on the caller's device
— ``tree``, ``looped`` and ``fused_hopper`` on CUDA, ``fused_torch`` in the
kernel's place on the CPU, ``looped`` left out for a resident exit — and
caches the winner per (chain shape, rows, sharing, gate, device, and the
operands' and exit's bases when they are not all SH).  In every measured
selection a kernel candidate that raises is not skipped: a kernel that
fails to build or launch must surface, not quietly lose the measurement.

Storage dtypes: 'float32', 'bfloat16' and 'float64' (plain routes only),
as in the reference.  A bf16 plan holds its operands and real constants at
bf16 and sums in f32 (complex grids stay complex64); its output is bf16.
``dtype='auto'`` with ``tune='measure'`` times the f32 and bf16 siblings
and keeps bf16 only where it wins (float32 under heuristic tuning), and
`GauntEngine.select_gate` picks where a chain's gate runs ('grid' fused
into the chain, or 'sh' after it) by timing both.

Every measured selection persists through the per-host autotune cache
(`core/autotune_cache.py`) when a cache path is configured: a warm process
answers every measured key from the file with zero timing runs.

`GauntEngine.calibrate_fused` measures the cost model's skinny-matmul
factor per storage dtype on the device, and the autotune cache persists it.

Sharding: ``plan_batch`` and ``plan_chain`` take a `ShardSpec`.  The rows
split over the mesh's data-parallel ranks (padded to a multiple of their
count), each rank runs the bucket or chain body on its own rows with plain
local tensors, so the kernels run as they do unsharded, and the rows are
gathered back (`distributed.sharding.scatter_rows` / `gather_rows`, each
the other's adjoint, so derivatives of any order pass through).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..spans import span
from . import constants
from .gaunt import expand_degree_weights  # re-exported where the reference defines it
from .irreps import num_coeffs

__all__ = [
    "KINDS",
    "PlanKey",
    "Backend",
    "GauntPlan",
    "BatchItem",
    "BatchedGauntPlan",
    "ShardSpec",
    "CHAIN_BACKENDS",
    "ChainPlan",
    "GauntEngine",
    "register_backend",
    "available_backends",
    "get_calibration",
    "set_calibration",
    "reset_calibration",
    "spectral_default",
    "build_escn",
    "expand_degree_weights",
    "get_engine",
    "plan",
    "plan_batch",
    "plan_chain",
]

CHAIN_BACKENDS = ("tree", "looped", "fused_torch", "fused_hopper")

_RDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}
_CDTYPE = {"float32": torch.complex64, "bfloat16": torch.complex64,
           "float64": torch.complex128}
# the accumulation dtype of each storage dtype: >= f32, never below storage
_ACC = {"float32": torch.float32, "bfloat16": torch.float32, "float64": torch.float64}


def _dtype_str(dtype) -> str:
    """A plan key's storage dtype from a dtype spec (complex dtypes name
    their real width, as the wrappers' cdtype does)."""
    s = dtype if isinstance(dtype, str) else str(dtype).replace("torch.", "")
    s = {"complex64": "float32", "complex128": "float64"}.get(s, s)
    if s not in _RDTYPE:
        raise ValueError(f"unsupported dtype {s!r} (expected one of {sorted(_RDTYPE)})")
    return s


def _wmul(x, w, L: int):
    return x if w is None else x * expand_degree_weights(w, L).to(x.dtype)


def _chain_entry_cast(x, rd):
    """The chain-entry dtype rule: an SH operand in another dtype than the
    plan's is cast once, at entry."""
    return x if x.dtype == rd else x.to(rd)


# --------------------------------------------------------------------------
# the affine gate — models.gate_apply, given its l=0 scalars
# --------------------------------------------------------------------------

# Y_00 = 1/(2 sqrt(pi)): one unit of SH coefficient 0 is this constant on S^2
_GATE_C0 = 0.5 / math.sqrt(math.pi)


def _gate_mlp(p, s):
    """The gate's scalar MLP: l=0 scalars s [..., C] -> gate g [..., C]."""
    return torch.sigmoid(F.silu(s @ p["w1"]) @ p["w2"])


def _gate_coeffs(p, s):
    """(g, beta): the gate in affine form, gate(x) = g*x + beta*e0 on packed
    SH (g*f + beta*Y00 on sphere samples), beta = silu(s) - g*s.  Affine in
    the signal, so it commutes with the projection and fuses into the
    collocation kernel as a per-row scale and shift."""
    g = _gate_mlp(p, s)
    return g, F.silu(s) - g * s


def _gate_sh(p, x):
    """Apply the gate on packed SH coefficients (== models.gate_apply), at
    the dtype of x and the gate weights (x promoted to theirs)."""
    x = x.to(torch.promote_types(x.dtype, p["w1"].dtype))
    s = x[..., 0]
    g = _gate_mlp(p, s)
    return torch.cat([F.silu(s)[..., None], x[..., 1:] * g[..., None]], dim=-1)


def _gate_rep(p, rep):
    """Apply the gate on a resident Rep without leaving the basis: the l=0
    scalars come from the z-transform's l0 row, the grid scales by g and
    beta*Y00 lands on the (u, v) = (0, 0) mode.  A dense grid is gated in
    its half form (lossless for the real functions a chain carries)."""
    from .rep import Rep

    form = rep.form
    Fh, L = rep.with_form("half").data, rep.L
    z0 = constants.to_torch(constants.z_half_l0(L, str(Fh.dtype)[6:]), Fh.device)
    s = torch.einsum("...uv,uv->...", Fh, z0).real
    g, beta = _gate_coeffs(p, s)
    Fh = Fh * g[..., None, None].to(Fh.dtype)
    bump = torch.zeros_like(Fh)
    bump[..., L, 0] = (beta * _GATE_C0).to(Fh.dtype)
    return Rep(Fh + bump, L, "fourier", "half").with_form(form)


# --------------------------------------------------------------------------
# plan keys and the backend registry
# --------------------------------------------------------------------------

KINDS = ("pairwise", "conv_filter", "manybody", "channel_mix")


def spectral_default(*Ls: int) -> str:
    """The dense-spectral conv crossover: shift-and-add 'direct' on small
    grids, 'fft' above (the reference's one home of ``conv='auto'``)."""
    return "direct" if max(Ls) <= 4 else "fft"


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of a planned Gaunt op (hashable; the plan-cache key).

    ``dtype`` is the storage dtype ('float32' | 'bfloat16' | 'float64';
    sums run at f32, f64 for f64); ``extra`` holds kind/backend options as
    sorted (name, value) pairs (packed and rfft take ("conv", ...),
    conv_filter ("geometry", "wigner")); ``device`` is the device type the
    plan is selected and measured for ('cuda' | 'cpu').
    """

    L1: int
    L2: int
    Lout: int
    kind: str = "pairwise"
    batch_hint: int | None = None
    dtype: str = "float32"
    extra: tuple = ()
    device: str = "cuda"

    def opt(self, name: str, default=None):
        return dict(self.extra).get(name, default)


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered Gaunt realization with capability flags.

    ``kernel`` marks a backend that runs a hand-written CUDA kernel: the
    measured selection times it only on the card (on the CPU it would time
    the kernel's plain version, which is not the candidate)."""

    name: str
    kinds: frozenset
    build: Callable = dataclasses.field(repr=False, compare=False, default=None)
    cost: Callable = dataclasses.field(repr=False, compare=False, default=None)
    supports_grad: bool = True
    dtypes: frozenset = frozenset({"float32", "bfloat16", "float64"})
    kernel: bool = False
    # spectral backends take and return Fourier-resident operands (Reps)
    fourier_boundary: bool = False
    # conv_filter backends that accept precomputed WignerBlocks geometry
    wigner_geometry: bool = False

    def eligible(self, key: PlanKey, requires_grad: bool) -> bool:
        if key.dtype not in self.dtypes:
            return False
        if requires_grad and not self.supports_grad:
            return False
        bound = key.opt("boundary")
        if bound and "fourier" in bound and not self.fourier_boundary:
            return False
        if key.opt("geometry") and not self.wigner_geometry:
            return False
        if key.kind in self.kinds:
            return True
        # any pairwise backend can serve conv_filter by materializing Y(rhat)
        return key.kind == "conv_filter" and "pairwise" in self.kinds


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    _REGISTRY[backend.name] = backend
    return backend


def available_backends(kind: str = "pairwise", dtype: str = "float32",
                       requires_grad: bool = True) -> list[str]:
    key = PlanKey(1, 1, 2, kind=kind, dtype=_dtype_str(dtype))
    return [b.name for b in _REGISTRY.values() if b.eligible(key, requires_grad)]


@dataclasses.dataclass(frozen=True)
class GauntPlan:
    """A resolved (key, backend) pair; ``apply`` runs the op."""

    key: PlanKey
    backend: str
    apply: Callable = dataclasses.field(repr=False, compare=False)

    def describe(self) -> str:
        k = self.key
        return (f"{k.kind}(L1={k.L1}, L2={k.L2}, Lout={k.Lout}, dtype={k.dtype}, "
                f"batch_hint={k.batch_hint}, device={k.device}) -> {self.backend}")


# --------------------------------------------------------------------------
# batched plans: ragged multi-degree workloads, one call per degree bucket
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchItem:
    """One entry of a batched workload: a degree signature and its expected
    rows.  ``size`` is a planning hint (it feeds the bucket's batch_hint);
    the row count comes from the tensors at apply time.  ``options`` are the
    item's plan options as sorted (name, value) pairs (e.g. ``boundary``).
    A manybody item carries its operands' degrees ``Ls`` instead of L1/L2."""

    L1: int | None = None
    L2: int | None = None
    Lout: int | None = None
    Ls: tuple | None = None
    size: int | None = None
    options: tuple = ()

    def signature(self) -> tuple:
        return (self.L1, self.L2, self.Lout, self.Ls, self.options)


def _as_batch_item(it) -> BatchItem:
    if isinstance(it, BatchItem):
        return it
    if isinstance(it, dict):
        d = dict(it)
        if "options" in d:
            d["options"] = tuple(sorted(dict(d["options"]).items()))
        if d.get("Ls") is not None:
            d["Ls"] = tuple(int(L) for L in d["Ls"])
        return BatchItem(**d)
    it = tuple(it)
    if len(it) == 3:
        return BatchItem(L1=it[0], L2=it[1], Lout=it[2])
    if len(it) == 4:
        return BatchItem(L1=it[0], L2=it[1], Lout=it[2], size=it[3])
    raise ValueError(f"batch item {it!r}: expected (L1, L2, Lout[, size]), "
                     "a dict, or a BatchItem")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a batched or chained apply is laid out over a device mesh.

    mesh : a `DeviceMesh` with named dims, or None for the launcher's
           activation mesh (`distributed.sharding.set_activation_mesh`);
           with neither the spec is inert and execution stays on one rank.
    axes : the mesh dims that may split the row axis (dim 0 of every
           flattened operand); the subset the mesh has is used.
    mode : 'constraint' or 'shard_map', the reference's two ways of handing
           the row layout to XLA (a sharding constraint for the SPMD
           partitioner, or a per-shard body).  torch has no partitioner to
           hand a constraint to: both modes run the same explicit per-rank
           body (scatter rows, run, gather rows) and give the same numbers,
           and the same plan: the mode is checked and keys nothing.
    """

    mesh: object = None
    axes: tuple = ("pod", "data")
    mode: str = "constraint"

    def resolve(self):
        """-> (mesh, dp_axes), or (None, ()) when no mesh is available."""
        from ..distributed import sharding as _sh

        if self.mode not in ("constraint", "shard_map"):
            raise ValueError(f"unknown shard mode {self.mode!r} "
                             "(expected 'constraint' or 'shard_map')")
        mesh = self.mesh if self.mesh is not None else _sh.get_activation_mesh()
        if mesh is None:
            return None, ()
        return mesh, _sh.dp_axes(mesh, tuple(self.axes))


def _map_leaves(fn, obj, memo: dict):
    """fn over every tensor of an operand tree (tensors, Reps, WignerBlocks,
    lists, tuples, None); a tensor or Rep met twice maps once, so shared
    operands stay shared (the chain converts a shared operand once)."""
    from .conv import WignerBlocks
    from .rep import Rep

    if obj is None:
        return None
    hit = memo.get(id(obj))
    if hit is not None:
        return hit[1]
    if isinstance(obj, torch.Tensor):
        out = fn(obj)
    elif isinstance(obj, Rep):
        out = Rep(_map_leaves(fn, obj.data, memo), obj.L, obj.basis, obj.form, obj.sdtype)
    elif isinstance(obj, WignerBlocks):
        out = WignerBlocks(tuple(_map_leaves(fn, b, memo) for b in obj.blocks))
    elif isinstance(obj, (list, tuple)):
        out = type(obj)(_map_leaves(fn, x, memo) for x in obj)
    else:
        return obj
    memo[id(obj)] = (obj, out)  # keep obj alive: its id stays unique
    return out


def _sharded_rows(run: Callable, rs, args: tuple):
    """Run ``run(*args)`` on this rank's rows: every tensor leaf of ``args``
    has the (padded) row axis first; the output's rows are gathered back."""
    from ..distributed.sharding import gather_rows, scatter_rows

    local = _map_leaves(lambda t: scatter_rows(t, rs), args, {})
    return _map_leaves(lambda t: gather_rows(t, rs), run(*local), {})


def _split_leads(leads: list) -> tuple:
    """Operand leading shapes -> (row prefix, inner broadcast dims), by
    numpy's shape rule (``torch.broadcast_shapes`` imports sympy on its
    first call: seconds, once a process).  The prefix is the longest run of leading dims on which every operand agrees
    (right-aligned): those flatten into rows.  The inner dims are where the
    operands broadcast (one edge direction against C channels); they pass
    through to the backend, which broadcasts them itself."""
    full = tuple(np.broadcast_shapes(*leads))
    n = len(full)
    padded = [(1,) * (n - len(ld)) + tuple(ld) for ld in leads]
    k = 0
    while k < n and all(p[k] == full[k] for p in padded):
        k += 1
    return full[:k], full[k:]


def _op_parts(op) -> tuple:
    """(leaves, event ranks, rebuild) of one operand: packed SH rows and raw
    directions have event rank 1, Rep grids and Wigner blocks rank 2, and
    ``rebuild`` wraps new leaves back into the operand's type."""
    from .conv import WignerBlocks
    from .rep import Rep

    if isinstance(op, Rep):
        meta = (op.L, op.basis, op.form, op.sdtype)
        return [op.data], (2,), lambda ls: Rep(ls[0], *meta)
    if isinstance(op, WignerBlocks):
        return list(op.blocks), (2,) * len(op.blocks), lambda ls: WignerBlocks(tuple(ls))
    return [op], (1,), lambda ls: ls[0]


def _weight_degrees(kind: str, item: BatchItem) -> tuple:
    """The packed width (L+1) of each weight slot of an item's apply: one
    per operand for manybody, (w1, w2, w3) otherwise."""
    if kind == "manybody":
        return tuple(L + 1 for L in item.Ls)
    return (item.L1 + 1, item.L2 + 1, item.Lout + 1)


def _norm_operand(op, j: int, kind: str, item: BatchItem, form: str):
    """SH Reps unwrap to their data; Fourier Reps check their bandlimit
    against the item's degree and take the bucket plan's storage form."""
    from .rep import Rep

    if isinstance(op, Rep):
        if op.basis == "sh":
            return op.data
        degs = item.Ls if kind == "manybody" else (item.L1, item.L2)
        if j < len(degs) and op.L != degs[j]:
            raise ValueError(f"operand {j}: resident bandlimit {op.L} != "
                             f"planned degree {degs[j]}")
        return op.with_form(form)
    return op


def _bucket_body(plan: GauntPlan, kind: str, item: BatchItem, granularity: int,
                 form: str, item_ops, item_ws, rs=None):
    """Flatten, broadcast, concatenate and pad the items' operands, run the
    bucket's plan once, slice each item's output back out (the reference's
    ``_bucket_batch_body``, eager).  With a `RowShard` ``rs`` the plan runs
    on this rank's rows (``granularity`` is a multiple of the rank count)."""
    from .rep import Rep

    rd = _RDTYPE[plan.key.dtype]
    wdeg = _weight_degrees(kind, item)
    item_parts = [[_op_parts(_norm_operand(op, j, kind, item, form))
                   for j, op in enumerate(ops)] for ops in item_ops]
    struct0 = [p[1] for p in item_parts[0]]
    for t, parts in enumerate(item_parts):
        if [p[1] for p in parts] != struct0:
            raise ValueError(f"item {t}: operand structure (Rep/WignerBlocks/"
                             "array mix) differs from the bucket's first item "
                             f"({[p[1] for p in parts]} vs {struct0})")
    splits = []
    for parts, ws in zip(item_parts, item_ws):
        leads = [tuple(leaf.shape[: leaf.dim() - er]) for leaves, ers, _ in parts
                 for leaf, er in zip(leaves, ers)]
        prefix, inner = _split_leads(leads)
        # a weight whose lead reaches beyond the operands' broadcast shape
        # broadens the output, which the row layout cannot express: the item
        # goes all-inner (one row) and the backend broadcasts it
        w_leads = [tuple(w.shape[:-1]) for w in ws if w is not None]
        pi = prefix + inner
        if any(tuple(np.broadcast_shapes(wl, pi)) != pi for wl in w_leads):
            prefix, inner = (), tuple(np.broadcast_shapes(pi, *w_leads))
        splits.append((prefix, inner))
    if len({inner for _, inner in splits}) > 1:
        splits = [(prefix + inner, ()) for prefix, inner in splits]
    rows = [int(np.prod(p)) if p else 1 for p, _ in splits]
    # per operand, per leaf: per item [rows, *inner, *event]
    cols = [[[] for _ in p[0]] for p in item_parts[0]]
    for t, parts in enumerate(item_parts):
        prefix, inner = splits[t]
        rank = len(prefix) + len(inner)
        for j, (leaves, ers, _) in enumerate(parts):
            for q, (x, er) in enumerate(zip(leaves, ers)):
                lead, ev = tuple(x.shape[: x.dim() - er]), tuple(x.shape[x.dim() - er:])
                pl = (1,) * (rank - len(lead)) + lead
                # broadcast the row prefix only: a size-1 inner dim stays
                # size 1 (the backend broadcasts it)
                x = x.reshape(*pl, *ev).expand(*prefix, *pl[len(prefix):], *ev)
                cols[j][q].append(x.reshape(rows[t], *pl[len(prefix):], *ev))
    if len(item_ops) > 1:
        # one item may still carry a size-1 inner dim the others have in full
        for j, (_, ers, _) in enumerate(item_parts[0]):
            for q, col in enumerate(cols[j]):
                if len({tuple(x.shape[1: x.dim() - ers[q]]) for x in col}) > 1:
                    for t, x in enumerate(col):
                        ev = tuple(x.shape[x.dim() - ers[q]:])
                        col[t] = x.expand(rows[t], *splits[t][1], *ev)
    ws_cat = []
    for j in range(len(wdeg)):
        if all(ws[j] is None for ws in item_ws):
            ws_cat.append(None)
            continue
        parts = []
        for t, ws in enumerate(item_ws):
            prefix, inner = splits[t]
            w = ws[j]
            if w is None:
                parts.append(torch.ones((rows[t], *inner, wdeg[j]), dtype=rd,
                                        device=cols[0][0][t].device))
            else:
                parts.append(w.expand(*prefix, *inner, wdeg[j])
                             .reshape(rows[t], *inner, wdeg[j]).to(rd))
        ws_cat.append(torch.cat(parts, dim=0))
    total = sum(rows)
    pad = -(-total // granularity) * granularity - total
    ops_cat = []
    for j, (_, ers, rebuild) in enumerate(item_parts[0]):
        cat = []
        for q, col in enumerate(cols[j]):
            x = torch.cat(col, dim=0) if len(col) > 1 else col[0]
            if pad:
                fill = x.new_zeros((pad, *x.shape[1:]))
                if kind == "conv_filter" and j == 1 and ers[q] == 1:
                    # raw directions pad with e_z: the alignment rotation of
                    # a zero vector is NaN
                    fill[..., 2] = 1
                x = torch.cat([x, fill], dim=0)
            cat.append(x)
        ops_cat.append(rebuild(cat))
    if pad:
        ws_cat = [None if w is None else
                  torch.cat([w, w.new_ones((pad, *w.shape[1:]))], dim=0) for w in ws_cat]
    def run(ops, ws):
        if kind == "manybody":
            return plan.apply(ops, None if all(w is None for w in ws) else ws)
        return plan.apply(*ops, *ws)

    out = run(ops_cat, ws_cat) if rs is None else _sharded_rows(run, rs, (ops_cat, ws_cat))
    leaf = out.data if isinstance(out, Rep) else out
    res, off = [], 0
    for t in range(len(item_ops)):
        o = leaf[off:off + rows[t]].reshape(*splits[t][0], *leaf.shape[1:])
        res.append(Rep(o, out.L, out.basis, out.form) if isinstance(out, Rep) else o)
        off += rows[t]
    return res


@dataclasses.dataclass(frozen=True)
class _Bucket:
    """Items sharing one degree signature, resolved to one inner plan."""

    item_ids: tuple
    plan: GauntPlan


@dataclasses.dataclass(frozen=True)
class BatchedGauntPlan:
    """A bucketed multi-degree workload; ``apply`` makes one call on each
    bucket's inner plan (see `GauntEngine.plan_batch`).

    ``donate`` is accepted for the reference's API and donates nothing: a
    bucket concatenates its items into fresh buffers and never writes the
    caller's, so there is no buffer a caller could hand over."""

    kind: str
    dtype: str
    items: tuple
    buckets: tuple
    granularity: int = 1
    donate: bool = False
    shard: ShardSpec | None = None
    _rows: object = dataclasses.field(default=None, repr=False, compare=False)

    def plans(self) -> list:
        return [b.plan for b in self.buckets]

    def describe(self) -> str:
        lines = [f"plan_batch(kind={self.kind}, dtype={self.dtype}, "
                 f"items={len(self.items)}, buckets={len(self.buckets)}, "
                 f"granularity={self.granularity}, donate={self.donate})"]
        for b in self.buckets:
            lines.append(f"  items {list(b.item_ids)} -> {b.plan.describe()}")
        return "\n".join(lines)

    def apply(self, inputs, weights=None) -> list:
        """Run every item -> outputs aligned with ``items``.

        inputs  : element i is item i's operands — (x1, x2) for
                  pairwise, (x, rhat or WignerBlocks) for conv_filter, the
                  xs sequence for manybody; SH tensors or, on a 'fourier'
                  boundary, Reps.
        weights : optional, element i is item i's (w1, w2, w3), or its
                  per-operand list for manybody (None entries allowed), or
                  None.
        """
        inputs = list(inputs)
        if len(inputs) != len(self.items):
            raise ValueError(f"apply got {len(inputs)} inputs for "
                             f"{len(self.items)} items")
        weights = [None] * len(self.items) if weights is None else list(weights)
        if len(weights) != len(self.items):
            raise ValueError(f"apply got {len(weights)} weight entries for "
                             f"{len(self.items)} items")
        outs = [None] * len(self.items)
        for bucket in self.buckets:
            item0 = self.items[bucket.item_ids[0]]
            n_ops = len(item0.Ls) if self.kind == "manybody" else 2
            n_ws = len(_weight_degrees(self.kind, item0))
            ops, ws = [], []
            for i in bucket.item_ids:
                o = tuple(inputs[i])
                if len(o) != n_ops:
                    raise ValueError(f"item {i}: expected {n_ops} operands, got {len(o)}")
                w = (None,) * n_ws if weights[i] is None else tuple(weights[i])
                if len(w) != n_ws:
                    raise ValueError(f"item {i}: expected {n_ws} weight slots, got {len(w)}")
                ops.append(o)
                ws.append(w)
            form = "half" if bucket.plan.backend == "rfft" else "dense"
            res = _bucket_body(bucket.plan, self.kind, item0, self.granularity, form,
                               ops, ws, self._rows)
            for t, i in enumerate(bucket.item_ids):
                outs[i] = res[t]
        return outs


# --------------------------------------------------------------------------
# chain plans
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A chained Gaunt product  x_1 (x) x_2 (x) ... (x) x_n  on one backend.

    ``apply(xs, weights=None, w_out=None, out_basis='sh', gate_params=None)``:
      xs      : per-operand SH tensors or Fourier-resident Reps
      weights : per-operand per-degree weights [..., L_i+1] (None entries ok)
      w_out   : per-degree output weights, applied after the exit (and gate)
      out_basis: 'sh' projects to degrees <= Lout; 'fourier' returns the
                resident product grid as a Rep (Lout == sum(Ls)), in the
                plan's ``conversion`` form on the spectral backends
      gate_params: {'w1', 'w2'} of the gate MLP — required iff ``gate``

    ``conversion``, ``conv`` and ``tree`` parameterize the ``tree``
    backend's spectral pass.
    """

    Ls: tuple
    Lout: int
    dtype: str
    backend: str
    gate: bool
    _apply: Callable = dataclasses.field(repr=False, compare=False)
    conversion: str = "half"
    conv: str = "rfft"
    tree: bool = True
    shard: tuple = (None, ())   # (mesh, dp_axes)

    def apply(self, xs, weights=None, w_out=None, out_basis: str = "sh",
              gate_params=None):
        if self.gate and gate_params is None:
            raise ValueError("this chain plan was built with gate=True; apply "
                             "needs gate_params={'w1', 'w2'}")
        if gate_params is not None and not self.gate:
            raise ValueError("gate_params passed to an ungated chain plan — "
                             "build it with plan_chain(..., gate=True)")
        if out_basis not in ("sh", "fourier"):
            raise ValueError(f"out_basis must be 'sh'|'fourier', got {out_basis!r}")
        xs = list(xs)
        if len(xs) != len(self.Ls):
            raise ValueError(f"chain got {len(xs)} operands for degrees {self.Ls}")
        ws = list(weights) if weights is not None else [None] * len(xs)
        if len(ws) != len(xs):
            raise ValueError(f"chain got {len(ws)} weight entries for "
                             f"{len(xs)} operands")
        if out_basis == "fourier":
            if w_out is not None:
                raise ValueError("w_out applies in SH; project first")
            if self.Lout != sum(self.Ls):
                raise ValueError(f"out_basis='fourier' keeps the full grid "
                                 f"(L={sum(self.Ls)}); plan with Lout={sum(self.Ls)}")
        return self._apply(xs, ws, w_out, out_basis, gate_params)


def _shard_chain(apply: Callable, rs) -> Callable:
    """Row-shard a chain backend: the leading dims on which every operand
    agrees (`_split_leads`) flatten into rows, a weight broadcast over them
    expands to them (a weight with no leading dims stays as it is), the rows
    pad with zeros to a multiple of the rank count (zero rows multiply to
    zero), each rank runs the chain on its own rows, and the rows are
    gathered back and unflattened.  A chain with no such dim runs whole on
    every rank."""
    from .rep import Rep

    def ev_rank(x):
        return 2 if isinstance(x, Rep) and x.is_fourier else 1

    def lead(x):
        t = x.data if isinstance(x, Rep) else x
        return tuple(t.shape[: t.dim() - ev_rank(x)])

    def apply_sharded(xs, ws, w_out, out_basis, gate_params):
        full = np.broadcast_shapes(*[lead(x) for x in xs])
        prefix, _ = _split_leads([lead(x) for x in xs])
        if not prefix:
            return apply(xs, ws, w_out, out_basis, gate_params)
        rows, k = math.prod(prefix), len(prefix)
        pad = -rows % rs.size

        def to_rows(t, er):
            ld = t.shape[: t.dim() - er]
            t = t.reshape(*(1,) * (len(full) - len(ld)), *t.shape)
            t = t.expand(*prefix, *t.shape[k:]).reshape(rows, *t.shape[k:])
            if pad:
                t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))], dim=0)
            return t

        memo: dict = {}

        def flat(x):
            if x is None or (isinstance(x, torch.Tensor) and x.dim() == 1):
                return x  # absent, or one weight for every row
            hit = memo.get(id(x))
            if hit is None:
                t = to_rows(x.data if isinstance(x, Rep) else x, ev_rank(x))
                if isinstance(x, Rep):
                    t = Rep(t, x.L, x.basis, x.form, x.sdtype)
                hit = memo[id(x)] = (x, t)
            return hit[1]

        # a weight for every row stays whole on each rank: it is kept out of
        # the args that `_sharded_rows` splits
        ws_all = (*ws, w_out)
        whole = [w if flat(w) is w else None for w in ws_all]

        def run(a, b):
            b = [bw if w is None else w for w, bw in zip(whole, b)]
            return apply(list(a), b[:-1], b[-1], out_basis, gate_params)

        out = _sharded_rows(run, rs, ([flat(x) for x in xs],
                                      [None if w is not None else flat(x)
                                       for w, x in zip(whole, ws_all)]))
        data = out.data if isinstance(out, Rep) else out
        data = data[:rows].reshape(*prefix, *data.shape[1:])
        if isinstance(out, Rep):
            return Rep(data, out.L, out.basis, out.form, out.sdtype)
        return data

    return apply_sharded


def _warm_spectral_constants(conversion: str, Ls, Lf: int, Lout: int, cd) -> None:
    """Build a spectral plan's conversion constants when it is planned, so
    its applies build none (and a captured step uploads none)."""
    cname = str(cd)[6:]
    warm_y = {"dense": constants.y_dense, "packed": constants.y_packed,
              "half": constants.y_half}[conversion]
    warm_z = {"dense": constants.z_dense, "packed": constants.z_packed,
              "half": constants.z_half}[conversion]
    for L in Ls:
        warm_y(L, cname)
    warm_z(Lf, Lout, cname)


def _build_chain(Ls: tuple, Lout: int, conversion: str, conv: str, dtype: str,
                 tree: bool) -> Callable:
    """The tree backend: convert each distinct operand once, combine the
    grids (a divide-and-conquer tree, or the left fold), project once."""
    from .gaunt import (conv2d_full, conv2d_herm, fourier_to_sh, sh_to_fourier,
                        sh_to_fourier_bydeg)
    from .manybody import _tree_convolve
    from .rep import Rep

    rd, cd = _RDTYPE[dtype], _CDTYPE[dtype]
    form = "half" if conversion == "half" else "dense"
    Ltot = sum(Ls)
    _warm_spectral_constants(conversion, Ls, Ltot, Lout, cd)

    def combine(grids):
        if tree:
            return _tree_convolve(grids, conv, herm=form == "half")
        fn = conv2d_herm if form == "half" else conv2d_full
        F = grids[0]
        for G in grids[1:]:
            F = fn(F, G, conv)
        return F

    def apply(xs, ws, w_out, out_basis, gate_params):
        grids: list = [None] * len(xs)
        groups: dict[int, list[int]] = {}
        for i, x in enumerate(xs):
            if isinstance(x, Rep):
                if x.is_fourier:
                    if x.L != Ls[i]:
                        raise ValueError(f"operand {i}: resident bandlimit {x.L} "
                                         f"!= planned degree {Ls[i]}")
                    if ws[i] is not None:
                        raise ValueError("resident operands cannot take "
                                         "per-degree weights (apply in SH)")
                    grids[i] = x.with_form(form).data
                    continue
                xs[i] = x.data
            groups.setdefault(id(xs[i]), []).append(i)
        for idxs in groups.values():
            x, L = _chain_entry_cast(xs[idxs[0]], rd), Ls[idxs[0]]
            if len(idxs) == 1 or len({id(ws[i]) for i in idxs}) == 1:
                Fg = sh_to_fourier(_wmul(x, ws[idxs[0]], L), L, conversion, cd)
                for i in idxs:
                    grids[i] = Fg
            else:
                # shared operand, different weights: one degree-resolved
                # conversion plus a cheap per-copy degree combination
                Fl = sh_to_fourier_bydeg(x, L, conversion, cd)
                for i in idxs:
                    grids[i] = (Fl.sum(-3) if ws[i] is None else
                                torch.einsum("...l,...luv->...uv", ws[i].to(Fl.dtype), Fl))
        Fp = combine(grids)
        if out_basis == "fourier":
            return Rep(Fp, Ltot, "fourier", form)
        return _wmul(fourier_to_sh(Fp, Ltot, Lout, conversion, rd), w_out, Lout)

    return apply


def _wrap_chain_gate(base: Callable, Lout: int) -> Callable:
    """Gate a spectral chain backend (tree, looped) at its exit: on the
    packed SH coefficients (before ``w_out``) or on the resident grid for a
    'fourier' exit."""

    def apply(xs, ws, w_out, out_basis, gate_params):
        out = base(xs, ws, None, out_basis, None)
        if out_basis == "fourier":
            return _gate_rep(gate_params, out)
        # the f32 gate MLP gates a bf16 exit in f32, rounded once back
        return _wmul(_gate_sh(gate_params, out).to(out.dtype), w_out, Lout)

    return apply


def _build_chain_looped(Ls: tuple, Lout: int, dtype: str,
                        engine: "GauntEngine") -> Callable:
    """The pre-residency strategy as a chain backend: a left fold of
    pairwise spectral plans, each product paying its full SH round trip —
    kept so the measured autotuner prices what residency buys."""
    from .rep import Rep

    rd = _RDTYPE[dtype]

    def apply(xs, ws, w_out, out_basis, gate_params):
        if out_basis != "sh":
            raise ValueError("the looped chain backend has no resident exit; "
                             "plan with backend='tree' for out_basis='fourier'")
        for i, x in enumerate(xs):
            if isinstance(x, Rep):
                # a resident operand leaves the basis here (lossless at its
                # own bandlimit): the fold works in SH
                xs[i] = x.to_sh(rdtype=rd).data if x.is_fourier else x.data
            xs[i] = _chain_entry_cast(xs[i], rd)
        acc = _wmul(xs[0], ws[0], Ls[0])
        La = Ls[0]
        for i, (x, L) in enumerate(zip(xs[1:], Ls[1:]), start=1):
            Lt = Lout if i == len(Ls) - 1 else La + L
            p = engine.plan(La, L, Lt, kind="pairwise", dtype=dtype,
                            backend=spectral_default(La, L), device=x.device)
            acc = p.apply(acc, x, None, ws[i])
            La += L
        return _wmul(acc.to(rd), w_out, Lout)

    return apply


def _build_chain_fused(Ls: tuple, Lout: int, dtype: str, kernel: bool,
                       gate: bool) -> Callable:
    """The n-way collocation chain: sample every operand onto the shared
    alias-free product grid, multiply pointwise n-way, project once — one
    kernel launch on ``fused_hopper``.  With ``gate`` the product's l=0
    scalars come from the multilinear form `constants.chain_l0` (the kernel
    cannot feed its own output to the gate MLP), the MLP turns them into
    per-row (g, beta*Y00) outside the kernel, and the kernel applies
    ``v <- v*g + beta*Y00`` to the product samples before projection."""
    from ..kernels.gaunt_fused import (gaunt_chain_fused_hopper,
                                       gaunt_chain_fused_torch)
    from .rep import Rep

    rd, acc = _RDTYPE[dtype], _ACC[dtype]
    Ltot = sum(Ls)
    # T at the storage dtype, P at the accumulation dtype
    for dt in {dtype, str(acc)[6:]}:
        constants.chain_matrices_folded(tuple(Ls), Lout, ("sh",) * len(Ls), "sh",
                                        dtype=dt)
    if gate:
        constants.chain_l0(tuple(Ls), ("sh",) * len(Ls))
    fn = gaunt_chain_fused_hopper if kernel else gaunt_chain_fused_torch

    def apply(xs, ws, w_out, out_basis, gate_params):
        entries, arrs = [], []
        for i, x in enumerate(xs):
            if isinstance(x, Rep) and x.is_fourier:
                if x.L != Ls[i]:
                    raise ValueError(f"operand {i}: resident bandlimit {x.L} "
                                     f"!= planned degree {Ls[i]}")
                if ws[i] is not None:
                    raise ValueError("resident operands cannot take per-degree "
                                     "weights (apply in SH)")
                entries.append("grid")
                arrs.append(x.with_form("half").data)
            else:
                if isinstance(x, Rep):
                    x = x.data
                entries.append("sh")
                arrs.append(_wmul(_chain_entry_cast(x, rd), ws[i], Ls[i]))
        gate_arg = None
        if gate:
            # the l=0 scalars at the accumulation dtype, from the stored
            # (entry-cast, weighted) operands
            flat = []
            for a, e in zip(arrs, entries):
                if e == "grid":
                    Fl = a.reshape(*a.shape[:-2], -1)
                    a = torch.cat([Fl.real, Fl.imag], dim=-1)
                flat.append(a.to(acc))
            M = constants.to_torch(constants.chain_l0(tuple(Ls), tuple(entries)),
                                   flat[0].device, acc)
            # s = einsum('...a,...b,...,ab...->...', *flat, M), contracted one
            # operand at a time: a multi-operand torch.einsum searches for a
            # contraction path on the host at every call
            t = flat[0] @ M.reshape(M.shape[0], -1)
            for a in flat[1:]:
                t = (a[..., :, None] * t.reshape(*t.shape[:-1], a.shape[-1], -1)).sum(-2)
            g, beta = _gate_coeffs(gate_params, t[..., 0])
            gate_arg = (g, beta * _GATE_C0)
        out = fn(arrs, Ls, Lout, entries=tuple(entries),
                 out_entry="grid" if out_basis == "fourier" else "sh",
                 dtype=dtype, gate=gate_arg)
        if out_basis == "fourier":
            return Rep(out, Ltot, "fourier", "half")
        return _wmul(out.to(rd), w_out, Lout)

    return apply


# --------------------------------------------------------------------------
# the eSCN (rotation-aligned) conv backend
# --------------------------------------------------------------------------


def build_escn(L1: int, L2: int, Lout: int, geometry: str | None = None,
               dtype: str = "float32") -> Callable:
    """The ``escn_aligned`` conv_filter backend: rotate x so the edge lies
    on the zenith, where the SH filter has only m = 0 components and its
    torus grid is the single v = 0 column; the 2D convolution becomes a
    banded 1D convolution along u; rotate back.  ``geometry='wigner'``
    takes precomputed `conv.WignerBlocks` instead of raw directions."""
    cd, rd = _CDTYPE[dtype], _RDTYPE[dtype]
    cname = str(cd)[6:]
    fl0 = np.array([math.sqrt((2 * l + 1) / (4 * math.pi)) for l in range(L2 + 1)],
                   dtype=np.float32)
    gidx, mask = constants.conv_u_index(L1, L2)
    pv = L2  # the v support stays |v| <= L1 inside the (2(L1+L2)+1)-wide grid

    def apply_conv(x, rhat, w1=None, w2=None, w3=None):
        from .conv import (WignerBlocks, align_rotation, apply_wigner_blocks,
                           wigner_blocks_from_rotmat)
        from .gaunt import fourier_to_sh, sh_to_fourier

        dev = x.device
        if geometry == "wigner":
            if not isinstance(rhat, WignerBlocks):
                raise ValueError("geometry='wigner' takes precomputed WignerBlocks "
                                 f"(EquivariantConv.geometry_rep), got {type(rhat).__name__}")
            if rhat.L < max(L1, Lout):
                raise ValueError(f"WignerBlocks cover degrees <= {rhat.L}, "
                                 f"need max(L1, Lout) = {max(L1, Lout)}")
            Ds = list(rhat.blocks)
        else:
            Ds = wigner_blocks_from_rotmat(max(L1, Lout),
                                           align_rotation(rhat.to(_ACC[dtype])))
        with span("conv.rotate", x):
            xr = apply_wigner_blocks(Ds[: L1 + 1], _wmul(x, w1, L1))
        with span("conv.to_fourier", x):
            F1 = sh_to_fourier(xr, L1, "dense", cd)
        with span("conv.filter", x):
            fl = constants.to_torch(fl0, dev, rd)
            if w2 is not None:
                fl = fl * w2.to(rd)
            cols = constants.to_torch(constants.filter_fourier_col(L2, cname), dev)
            k = torch.einsum("...l,lu->...u", fl.to(cols.dtype), cols)
            kmat = k[..., constants.to_torch(gidx, dev, torch.int64)] \
                * constants.to_torch(mask, dev, rd)
            F3 = torch.einsum("...ti,...iv->...tv", kmat, F1)
            z = F3.new_zeros(F3.shape[:-1] + (pv,))
            F3 = torch.cat([z, F3, z], dim=-1)
        with span("conv.to_sh", x):
            out_rot = fourier_to_sh(F3, L1 + L2, Lout, "dense", rd)
        with span("conv.rotate_back", x):
            return _wmul(apply_wigner_blocks(Ds[: Lout + 1], out_rot, transpose=True),
                         w3, Lout)

    return apply_conv


# --------------------------------------------------------------------------
# cost model (relative real-MAC counts), as the reference's
# --------------------------------------------------------------------------

_C_CPLX = 4.0        # complex MAC = 4 real MACs
_C_FFT = 10.0        # per point per log2 level: tiny-grid FFTs vectorize poorly
_OVERHEAD = 3e4      # per dispatched op: favors fewer, denser ops at small sizes
_INTERPRET_PENALTY = 1e4   # a kernel backend off the card runs its plain version

# 'fused_skinny' scales the collocation backends' per-element cost (their
# matmuls are skinny, G >> d).  4.0 is the reference's never-calibrated
# default; the per-dtype entries inherit it (None) until
# `GauntEngine.calibrate_fused` measures them.
_CALIB = {
    "fused_skinny": 4.0, "fused_skinny_measured": False,
    "fused_skinny:bfloat16": None, "fused_skinny:bfloat16_measured": False,
    "fused_skinny:float64": None, "fused_skinny:float64_measured": False,
}
_CALIB_DEFAULTS = dict(_CALIB)


def _calib_key(dtype: str) -> str:
    return "fused_skinny" if dtype == "float32" else f"fused_skinny:{dtype}"


def _calib_factor(dtype: str) -> float:
    v = _CALIB.get(_calib_key(dtype))
    return _CALIB["fused_skinny"] if v is None else v


def get_calibration() -> dict:
    """The cost model's calibration constants (see `_CALIB`)."""
    return dict(_CALIB)


def set_calibration(**kw) -> None:
    """Override calibration constants (tests / cross-host replay).  Per-dtype
    entries use the key 'fused_skinny:<dtype>' (pass them by dict-splat)."""
    unknown = set(kw) - set(_CALIB)
    if unknown:
        raise ValueError(f"unknown calibration constants {sorted(unknown)}")
    _CALIB.update(kw)


def reset_calibration() -> None:
    """Restore the default calibration constants (``GauntEngine.clear``
    calls it, so a cleared engine ranks backends like a fresh one)."""
    _CALIB.clear()
    _CALIB.update(_CALIB_DEFAULTS)


def _dims(key: PlanKey):
    B = key.batch_hint or 1
    n1, n2 = 2 * key.L1 + 1, 2 * key.L2 + 1
    N = n1 + n2 - 1
    return B, num_coeffs(key.L1), num_coeffs(key.L2), num_coeffs(key.Lout), n1, n2, N


def _cost_dense_einsum(key: PlanKey) -> float:
    B, d1, d2, do, *_ = _dims(key)
    if key.kind == "channel_mix":
        return 16.0 * B * d1 * d2 * do + _OVERHEAD  # x C1*C2 (unknown): scaled proxy
    if key.kind == "manybody":
        Ls = key.opt("Ls")
        total, La = 0.0, Ls[0]
        for L in Ls[1:]:
            total += B * num_coeffs(La) * num_coeffs(L) * num_coeffs(La + L)
            La += L
        return total + _OVERHEAD * len(Ls)
    return B * d1 * d2 * do + _OVERHEAD


def _spectral_common(key: PlanKey, conv: str, packed: bool) -> float:
    B, d1, d2, do, n1, n2, N = _dims(key)
    if packed:  # O(L^3) stacked matmuls
        conv_in = 4.0 * B * (key.L1 + 1) ** 3 + 4.0 * B * (key.L2 + 1) ** 3
        proj = 8.0 * B * (key.Lout + 1) ** 2 * N
    else:  # O(L^4) dense einsum conversions
        conv_in = 2.0 * B * (d1 * n1 * n1 + d2 * n2 * n2)
        proj = _C_CPLX * B * N * N * do
    if conv == "fft":
        c = 3.0 * _C_FFT * B * N * N * max(1.0, math.log2(N * N)) + _C_CPLX * B * N * N
    else:
        c = _C_CPLX * B * N * N * n2 * n2
    n_ops = 8 if not packed else 14
    return conv_in + c + proj + _OVERHEAD * n_ops


def _cost_manybody_spectral(key: PlanKey, conv: str) -> float:
    """A manybody key on the dense-grid spectral backends (packed included,
    costed as dense, as in the reference): every operand's conversion, the
    grid combinations at the product grid, one projection."""
    Ls = key.opt("Ls")
    B = key.batch_hint or 1
    N = 2 * sum(Ls) + 1
    if conv == "fft":
        convs = _C_FFT * len(Ls) * B * N * N * max(1.0, math.log2(N * N))
    else:
        convs = _C_CPLX * len(Ls) * B * N * N * (2 * max(Ls) + 1) ** 2
    conv_in = sum(2.0 * B * num_coeffs(L) * (2 * L + 1) ** 2 for L in Ls)
    proj = _C_CPLX * B * N * N * num_coeffs(key.Lout)
    return conv_in + convs + proj + _OVERHEAD * (6 + 2 * len(Ls))


def _cost_spectral(key: PlanKey, conv: str, packed: bool) -> float:
    if key.kind == "manybody":
        return _cost_manybody_spectral(key, conv)
    return _spectral_common(key, conv, packed)


def _cost_rfft(key: PlanKey) -> float:
    """Half (Hermitian) conversions + real spatial rfft convolution."""
    B, d1, d2, do, n1, n2, N = _dims(key)
    if key.kind == "manybody":
        Ls = key.opt("Ls")
        Lt = sum(Ls)
        Nr = 2 * Lt + 2
        conv_in = sum(2.0 * B * num_coeffs(L) * (2 * L + 1) * (L + 1) for L in Ls)
        convs = 1.5 * _C_FFT * len(Ls) * B * Nr * Nr * max(1.0, math.log2(Nr * Nr))
        proj = _C_CPLX * B * Nr * (Lt + 1) * num_coeffs(key.Lout) / 2
        return conv_in + convs + proj + _OVERHEAD * (6 + 2 * len(Ls))
    Nr = N + 1  # the even alias-free spatial grid 2(L1+L2)+2
    conv_in = 2.0 * B * (d1 * n1 * (key.L1 + 1) + d2 * n2 * (key.L2 + 1))
    c = 1.5 * _C_FFT * B * Nr * Nr * max(1.0, math.log2(Nr * Nr)) + B * Nr * Nr
    proj = _C_CPLX * B * N * (key.L1 + key.L2 + 1) * do / 2
    return conv_in + c + proj + _OVERHEAD * 9


def _cost_fused(key: PlanKey, kernel: bool) -> float:
    """The reference's collocation cost, G padded to 128 lanes as there (the
    port's kernels run G unpadded and folded; the cost model keeps the
    reference's ranking).  The kernel backend costs half on the card and
    the interpret penalty off it."""
    B, d1, d2, do, n1, n2, N = _dims(key)
    Nf = 2 * (key.L1 + key.L2) + 2
    G = ((Nf * Nf + 127) // 128) * 128
    f = _calib_factor(key.dtype)
    c = f * B * G * (d1 + d2 + do) + _OVERHEAD * 4
    if key.kind == "channel_mix":
        c = 4.0 * f * B * G * (d1 + d2 + do) + _OVERHEAD * 4
    if kernel:
        c *= 0.5 if key.device == "cuda" else _INTERPRET_PENALTY
    return c


def _cost_escn(key: PlanKey) -> float:
    B, d1, d2, do, n1, n2, N = _dims(key)
    Lw = max(key.L1, key.Lout)
    wigner = B * sum((2 * l + 1) ** 4 for l in range(2, Lw + 1)) + \
        2.0 * B * sum((2 * l + 1) ** 2 for l in range(Lw + 1))
    s2f = 2.0 * B * d1 * n1 * n1
    banded = _C_CPLX * B * N * n1 * n1
    proj = _C_CPLX * B * N * N * do
    return wigner + s2f + banded + proj + _OVERHEAD * 10


# --------------------------------------------------------------------------
# pairwise backend builders
# --------------------------------------------------------------------------


def _gaunt_contract(x1, x2, G):
    """sum_ij x1[..., i] x2[..., j] G[i, j, k], one operand at a time (a
    3-operand torch.einsum searches for a contraction path on the host at
    every call).  Leading dims broadcast."""
    d1, d2, do = G.shape
    t = (x1 @ G.reshape(d1, d2 * do)).reshape(*x1.shape[:-1], d2, do)
    return (x2.unsqueeze(-2) @ t).squeeze(-2)


def _build_dense_einsum(key: PlanKey) -> Callable:
    """G and the operands at the storage dtype, the contraction at the
    accumulation dtype (a bf16 key stores G at bf16 and sums in f32, the
    reference's ``preferred_element_type``); the output at the storage
    dtype."""
    rd, acc = _RDTYPE[key.dtype], _ACC[key.dtype]
    G = constants.gaunt_dense(key.L1, key.L2, key.Lout, key.dtype)

    def stored(x):
        return x.to(rd).to(acc)

    if key.kind == "manybody":
        Ls = key.opt("Ls")
        # the left fold, one exact Gaunt tensor per product; each partial
        # product is stored at the storage dtype, as the reference's einsum
        # chain rounds it
        Gs, La = [], Ls[0]
        for i, L in enumerate(Ls[1:]):
            Gs.append(constants.gaunt_dense(La, L, key.Lout if i == len(Ls) - 2 else La + L,
                                            key.dtype))
            La += L

        def apply_mb(xs, weights=None):
            xs = list(xs)
            if weights is not None:
                xs = [_wmul(x, w, L) for x, w, L in zip(xs, weights, Ls)]
            out = xs[0]
            for x, G in zip(xs[1:], Gs):
                out = _gaunt_contract(stored(out), stored(x),
                                      constants.to_torch(G, x.device, acc)).to(rd)
            return out

        return apply_mb
    if key.kind == "channel_mix":

        def apply_mix(x1, x2, w_mix):
            # y[..., e, k] = sum_{c,d} w[c,d,e] sum_ij x1[..., c, i] x2[..., d, j] G[i,j,k]
            Gt = constants.to_torch(G, x1.device, acc)
            d1, d2, do = Gt.shape
            t = (stored(x1) @ Gt.reshape(d1, d2 * do)).reshape(*x1.shape[:-1], d2, do)
            W = stored(x2).unsqueeze(-3) @ t                     # [..., C1, C2, do]
            C1, C2, E = w_mix.shape
            out = stored(w_mix).reshape(C1 * C2, E).T @ W.reshape(*W.shape[:-3], C1 * C2, do)
            return out.to(rd)

        return apply_mix

    def apply_pair(x1, x2, w1=None, w2=None, w3=None):
        Gt = constants.to_torch(G, x1.device, acc)
        out = _gaunt_contract(stored(_wmul(x1, w1, key.L1)),
                              stored(_wmul(x2, w2, key.L2)), Gt)
        return _wmul(out.to(rd), w3, key.Lout)

    return apply_pair


def _resident_grid(op, L: int, form: str):
    """A 'fourier' boundary operand: a Rep (validated) or a raw grid."""
    from .rep import Rep

    if isinstance(op, Rep):
        if op.basis != "fourier":
            raise ValueError("boundary='fourier' operand must be Fourier-resident "
                             f"(got basis={op.basis!r}; convert with .to_fourier())")
        if op.L != L:
            raise ValueError(f"resident operand bandlimit {op.L} != planned degree {L}")
        return op.with_form(form).data
    return op


def _build_spectral(key: PlanKey, conversion: str, conv: str) -> Callable:
    """The spectral pairwise backends; a 'fourier' boundary skips that
    operand's conversion (its grid enters as is) or the exit projection
    (the product grid leaves as a resident Rep)."""
    from .gaunt import conv2d_full, conv2d_herm, fourier_to_sh, sh_to_fourier

    cd, rd = _CDTYPE[key.dtype], _RDTYPE[key.dtype]
    form = "half" if conversion == "half" else "dense"
    conv_fn = conv2d_herm if conversion == "half" else conv2d_full
    L1, L2, Lout = key.L1, key.L2, key.Lout
    if key.kind == "manybody":
        from .manybody import _tree_convolve

        Ls = key.opt("Ls")
        Ltot = sum(Ls)
        _warm_spectral_constants(conversion, Ls, Ltot, Lout, cd)

        def apply_mb(xs, weights=None):
            grids = []
            for i, (x, L) in enumerate(zip(xs, Ls)):
                w = None if weights is None else weights[i]
                grids.append(sh_to_fourier(_wmul(x, w, L), L, conversion, cd))
            F = _tree_convolve(grids, conv, herm=conversion == "half")
            return fourier_to_sh(F, Ltot, Lout, conversion, rd)

        return apply_mb
    _warm_spectral_constants(conversion, (L1, L2), L1 + L2, Lout, cd)
    b1, b2, bo = key.opt("boundary") or ("sh", "sh", "sh")

    def convert_in(x, w, L, b):
        if b == "fourier":
            if w is not None:
                raise ValueError("per-degree weights need an SH operand; apply "
                                 "them before converting to the Fourier basis")
            return _resident_grid(x, L, form)
        return sh_to_fourier(_wmul(x, w, L), L, conversion, cd)

    def apply_pair(x1, x2, w1=None, w2=None, w3=None):
        with span("conv.to_fourier", x1):
            G1, G2 = convert_in(x1, w1, L1, b1), convert_in(x2, w2, L2, b2)
        with span("conv.conv2d", x1):
            F3 = conv_fn(G1, G2, conv)
        if bo == "fourier":
            from .rep import Rep

            if w3 is not None:
                raise ValueError("w3 applies in SH; a Fourier-boundary output "
                                 "cannot carry per-degree output weights")
            return Rep(F3, L1 + L2, "fourier", form)
        with span("conv.to_sh", x1):
            return _wmul(fourier_to_sh(F3, L1 + L2, Lout, conversion, rd), w3, Lout)

    return apply_pair


def _build_fused(key: PlanKey, kernel: bool) -> Callable:
    """The collocation product on the folded pair matrices
    (`constants.pair_matrices`): ``fused_torch`` in torch ops,
    ``fused_hopper`` on the pair kernel (f32 storage: tensor cores in
    3xTF32 on `constants.pair_fragments`; bf16 storage: bf16 sampling
    products on `constants.pair_fragments_bf16`).  Operands and T1, T2 at
    the storage dtype (f32 or bf16), P and every sum at f32."""
    from ..kernels.gaunt_fused import gaunt_fused_hopper, gaunt_fused_torch

    rd = _RDTYPE[key.dtype]
    L1, L2, Lout = key.L1, key.L2, key.Lout
    T1n, T2n, _ = constants.pair_matrices(L1, L2, Lout, dtype=key.dtype)
    Pn = constants.pair_matrices(L1, L2, Lout)[2]
    if kernel:
        (constants.pair_fragments_bf16 if key.dtype == "bfloat16"
         else constants.pair_fragments)(L1, L2, Lout)
    if key.kind == "channel_mix":

        def apply_mix(x1, x2, w_mix):
            # y = (sum_{c,d} w[c,d,e] V1[c] * V2[d]) @ P,  V_i = x_i @ T_i:
            # the channel mix commutes with the basis change
            T1, T2, P = (constants.to_torch(a, x1.device) for a in (T1n, T2n, Pn))
            V1 = x1.to(rd).to(torch.float32) @ T1                # [..., C1, G]
            V2 = x2.to(rd).to(torch.float32) @ T2                # [..., C2, G]
            C1, C2, E = w_mix.shape
            U = w_mix.to(torch.float32).reshape(C1, C2 * E).T @ V1
            U = U.reshape(*U.shape[:-2], C2, E, U.shape[-1])     # [..., C2, E, G]
            V = (V2.unsqueeze(-2) * U).sum(-3)                   # [..., E, G]
            return (V @ P).to(rd)

        return apply_mix
    fn = gaunt_fused_hopper if kernel else gaunt_fused_torch

    def apply_pair(x1, x2, w1=None, w2=None, w3=None):
        out = fn(_wmul(x1, w1, L1), _wmul(x2, w2, L2), L1, L2, Lout, dtype=rd)
        return _wmul(out.to(rd), w3, Lout)

    return apply_pair


def _wrap_conv_filter(key: PlanKey, pair_apply: Callable) -> Callable:
    """Serve kind='conv_filter' on a pairwise backend: materialize Y(rhat)."""
    from .so3 import real_sph_harm_torch

    def apply_conv(x, rhat, w1=None, w2=None, w3=None):
        filt = real_sph_harm_torch(key.L2, rhat).to(x.dtype)
        return pair_apply(x, filt, w1, w2, w3)

    return apply_conv


def _build_plan_apply(spec: Backend, key: PlanKey) -> Callable:
    apply = spec.build(key)
    if key.kind == "conv_filter" and spec.name != "escn_aligned":
        apply = _wrap_conv_filter(key, apply)
    return apply


register_backend(Backend(
    name="dense_einsum",
    kinds=frozenset({"pairwise", "conv_filter", "manybody", "channel_mix"}),
    build=_build_dense_einsum,
    cost=_cost_dense_einsum,
))
register_backend(Backend(
    name="fft",
    kinds=frozenset({"pairwise", "conv_filter", "manybody"}),
    build=lambda key: _build_spectral(key, "dense", "fft"),
    cost=lambda key: _cost_spectral(key, "fft", packed=False),
    fourier_boundary=True,
))
register_backend(Backend(
    name="direct",
    kinds=frozenset({"pairwise", "conv_filter", "manybody"}),
    build=lambda key: _build_spectral(key, "dense", "direct"),
    cost=lambda key: _cost_spectral(key, "direct", packed=False),
    fourier_boundary=True,
))
register_backend(Backend(
    name="packed",
    kinds=frozenset({"pairwise", "conv_filter", "manybody"}),
    build=lambda key: _build_spectral(key, "packed", key.opt("conv", "fft")),
    cost=lambda key: _cost_spectral(key, key.opt("conv", "fft"), packed=True),
    fourier_boundary=True,
))
register_backend(Backend(
    name="rfft",
    kinds=frozenset({"pairwise", "conv_filter", "manybody"}),
    build=lambda key: _build_spectral(key, "half", key.opt("conv", "rfft")),
    cost=_cost_rfft,
    fourier_boundary=True,
))
register_backend(Backend(
    name="fused_torch",
    kinds=frozenset({"pairwise", "conv_filter", "channel_mix"}),
    build=lambda key: _build_fused(key, kernel=False),
    cost=lambda key: _cost_fused(key, kernel=False),
    dtypes=frozenset({"float32", "bfloat16"}),
))
register_backend(Backend(
    name="fused_hopper",
    kinds=frozenset({"pairwise", "conv_filter"}),
    build=lambda key: _build_fused(key, kernel=True),
    cost=lambda key: _cost_fused(key, kernel=True),
    supports_grad=False,  # the pair kernel has no backward, as the reference's
    dtypes=frozenset({"float32", "bfloat16"}),
    kernel=True,
))
register_backend(Backend(
    name="escn_aligned",
    kinds=frozenset({"conv_filter"}),
    build=lambda key: build_escn(key.L1, key.L2, key.Lout, geometry=key.opt("geometry"),
                                 dtype=key.dtype),
    cost=_cost_escn,
    wigner_geometry=True,
))


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


class GauntEngine:
    """Plans, caches and autotunes Gaunt ops: pairwise/conv_filter/
    channel_mix plans over the backend registry, and chain plans."""

    def __init__(self, cache_path: str | None = None):
        self._plans: dict = {}
        self._batched: dict = {}
        self._chains: dict = {}
        # measured picks, keyed by PlanKey (plans) or the chain tuple
        self._measured: dict = {}
        self._measured_t: dict = {}      # key -> the pick's median seconds
        self.measured_times: dict = {}   # key -> {backend: median seconds}
        self.measured_spread: dict = {}  # key -> {backend: (min, max) seconds}
        self.measure_errors: dict = {}   # PlanKey -> {backend: error} (non-kernel)
        # chain keys pinned by `pinned_chain`: their pick is not a
        # measurement, so a flush inside the block must not persist it
        self._pins: set = set()
        # persistent autotune cache (core/autotune_cache.py): off unless a
        # path is set here, by set_autotune_cache, or by
        # $REPRO_TORCH_AUTOTUNE_CACHE; loaded lazily at the first
        # measure-mode miss
        self._cache_path = cache_path
        self._cache_loaded = False
        # the last load found a file it could not use (corrupt, unreadable,
        # another fingerprint) or was declared unusable: measurement is cold
        self.cache_unusable = False
        # timed measurement passes (plan backends, chain candidates); a
        # process booted against a warm cache keeps it at 0
        self.timing_runs = 0
        # host seconds spent timing each chain candidate (its build, two
        # warm calls and the timed ones): what a cold warmup pays per name
        self.chain_timing_s: dict = {}

    # -- persistent autotune cache -----------------------------------------

    def set_autotune_cache(self, path: str | None) -> None:
        """Point this engine at a persistent cache file (None: fall back to
        $REPRO_TORCH_AUTOTUNE_CACHE, or disabled).  The next measure-mode
        miss loads it; every new measurement flushes to it."""
        self._cache_path = path
        self._cache_loaded = False
        self.cache_unusable = False

    def cache_path(self) -> str | None:
        """The effective cache path, or None when persistence is off."""
        from . import autotune_cache as _ac

        return _ac.resolve_path(self._cache_path)

    def load_autotune_cache(self) -> int:
        """Load the persisted selections, timings and calibration now
        (in-process entries win over the file's) -> selections adopted."""
        self._cache_loaded = True
        self.cache_unusable = False
        path = self.cache_path()
        if path is None:
            return 0
        from . import autotune_cache as _ac

        data = _ac.load(path)
        if data is None:
            self.cache_unusable = os.path.exists(path)
            return 0
        selections, timings, calib = data
        n = 0
        for k, b in selections.items():
            if k not in self._measured:
                self._measured[k] = b
                n += 1
        for k, t in timings.items():
            self._measured_t.setdefault(k, t)
        _ac.merge_calibration(calib)
        return n

    def _maybe_load_cache(self) -> None:
        if not self._cache_loaded:
            self.load_autotune_cache()

    def skip_autotune_cache(self) -> None:
        """Treat the cache as unreadable until the next `set_autotune_cache`
        or `clear`: nothing is loaded, so every miss measures cold (the
        serve engine's response to the ``autotune_cache_load`` fault)."""
        self._cache_loaded = True
        self.cache_unusable = True

    def flush_autotune_cache(self) -> str | None:
        """Persist the measurement stores (atomic, merging); pinned picks
        are left out.  No-op without a cache path -> the path written."""
        path = self.cache_path()
        if path is None:
            return None
        from . import autotune_cache as _ac

        sel = {k: v for k, v in self._measured.items() if k not in self._pins}
        _ac.save(path, sel, {k: t for k, t in self._measured_t.items() if k in sel},
                 calibration=get_calibration())
        return path

    def _autoflush(self) -> None:
        """Flush after a new measurement: an unwritable cache file degrades
        to in-process autotune, never breaks planning."""
        try:
            self.flush_autotune_cache()
        except OSError:
            pass

    # -- pairwise plans ----------------------------------------------------

    def plan(self, L1: int | None = None, L2: int | None = None,
             Lout: int | None = None, *, kind: str = "pairwise",
             Ls: tuple | None = None, batch_hint: int | None = None, dtype="float32",
             backend: str | None = None, options: dict | None = None,
             tune: str = "heuristic", requires_grad: bool = True,
             device=None) -> GauntPlan:
        """Resolve (and cache) a plan.  ``backend=None`` -> engine selection:
        ``tune='heuristic'`` (cost model) or ``'measure'`` (timed on
        ``device`` at ``batch_hint`` rows).  ``dtype`` is the storage dtype
        ('float32' | 'bfloat16' | 'float64'); 'auto' with ``tune='measure'``
        times the f32 and bf16 siblings and keeps bf16 only where it wins
        (float32 under heuristic tuning).  ``options={'boundary': (b1, b2,
        bo)}`` ('sh' | 'fourier' each) makes x1, x2 or the output
        Fourier-resident on the spectral backends.  ``device`` is the device
        the plan is selected for: None means cuda, and raises without a GPU
        (pass ``device="cpu"``).  ``requires_grad=False`` admits gradless
        backends (``fused_hopper``).  ``kind='manybody'`` takes ``Ls`` (the
        operands' degrees, n >= 2) instead of L1/L2."""
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r} (expected one of {KINDS})")
        if tune not in ("heuristic", "measure"):
            raise ValueError(f"unknown tune {tune!r} (expected 'heuristic'|'measure')")
        options = dict(options or {})
        bound = options.get("boundary")
        if bound is not None:
            bound = tuple(bound)
            if kind != "pairwise":
                raise ValueError("boundary options are only defined for "
                                 "pairwise plans (chains cover the rest)")
            if len(bound) != 3 or any(b not in ("sh", "fourier") for b in bound):
                raise ValueError(f"boundary must be 3 entries of 'sh'|'fourier', "
                                 f"got {bound!r}")
            if bound == ("sh", "sh", "sh"):
                options.pop("boundary")  # the default: do not fragment the cache
            else:
                options["boundary"] = bound
        geom = options.get("geometry")
        if geom is not None:
            if kind != "conv_filter":
                raise ValueError("geometry options only apply to conv_filter "
                                 "plans (precomputed Wigner alignment)")
            if geom != "wigner":
                raise ValueError(f"unknown geometry {geom!r} (expected 'wigner')")
        extra = tuple(sorted(options.items()))
        if kind == "manybody":
            if Ls is None or len(Ls) < 2:
                raise ValueError("manybody plans need Ls with >= 2 degrees")
            Ls = tuple(int(L) for L in Ls)
            L1, L2 = max(Ls), min(Ls)
            Lout = sum(Ls) if Lout is None else Lout
            extra += (("Ls", Ls),)
        else:
            if L1 is None or L2 is None:
                raise ValueError(f"kind={kind!r} plans need L1 and L2")
            Lout = L1 + L2 if Lout is None else Lout
        if Lout > (sum(Ls) if kind == "manybody" else L1 + L2):
            raise ValueError("Lout cannot exceed the total degree (Gaunt selection rule)")
        if bound is not None and bound[2] == "fourier" and Lout != L1 + L2:
            raise ValueError("a Fourier-boundary output keeps the full product "
                             f"grid (L={L1 + L2}); plan with Lout={L1 + L2} and "
                             "project at the chain exit")
        dev = resolve_device(device).type
        if isinstance(dtype, str) and dtype == "auto":
            dts = self._select_dtype(
                lambda d: PlanKey(L1, L2, Lout, kind, batch_hint, d, extra, dev),
                tune=tune, requires_grad=requires_grad)
        else:
            dts = _dtype_str(dtype)
        key = PlanKey(L1, L2, Lout, kind, batch_hint, dts, extra, dev)
        cache_key = (key, backend, tune, requires_grad)
        hit = self._plans.get(cache_key)
        if hit is not None:
            return hit
        name = backend or self.select(key, tune=tune, requires_grad=requires_grad)
        spec = _REGISTRY.get(name)
        if spec is None:
            raise ValueError(f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}")
        if not spec.eligible(key, requires_grad):
            raise ValueError(f"backend {name!r} cannot serve {key} "
                             f"(requires_grad={requires_grad})")
        p = self._plans[cache_key] = GauntPlan(key, name, _build_plan_apply(spec, key))
        return p

    def plan_batch(self, items, *, kind: str = "pairwise", dtype="float32",
                   backend: str | None = None, tune: str = "heuristic",
                   requires_grad: bool = True, donate: bool = False,
                   shard_spec=None, pad_to: int | None = None,
                   device=None) -> BatchedGauntPlan:
        """Plan a ragged multi-degree workload as bucketed calls.

        items: (L1, L2, Lout[, size]) tuples, dicts or `BatchItem`s.  Items
        sharing a degree signature (and options) form one bucket: their
        operands flatten to rows, concatenate, tail-pad to ``pad_to`` rows
        and run as ONE call on the bucket's plan, and the per-item results
        are sliced back — equal to per-plan calls (every backend is
        row-parallel).  A bucket's ``batch_hint`` is the sum of its items'
        ``size`` hints.  Manybody items carry ``Ls`` and bucket by it.
        ``dtype='auto'`` resolves per bucket, as ``plan`` does.  ``donate``
        is accepted and donates nothing (see `BatchedGauntPlan`).
        ``shard_spec`` (a `ShardSpec`) splits each bucket's rows over the
        mesh's data-parallel ranks: the row granularity becomes
        lcm(``pad_to``, rank count), so ragged row counts pad to equal
        shards and slice back, and every rank gets every item's output.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r} (expected one of {KINDS})")
        if kind == "channel_mix":
            raise ValueError("plan_batch does not support kind='channel_mix': "
                             "w_mix is not a row-batched operand (use plan())")
        norm = []
        for it in items:
            it = _as_batch_item(it)
            if kind == "manybody":
                if it.Ls is None or len(it.Ls) < 2:
                    raise ValueError("manybody batch items need Ls with >= 2 degrees")
                if it.Lout is None:
                    it = dataclasses.replace(it, Lout=sum(it.Ls))
            else:
                if it.L1 is None or it.L2 is None:
                    raise ValueError(f"kind={kind!r} batch items need L1 and L2")
                if it.Lout is None:
                    it = dataclasses.replace(it, Lout=it.L1 + it.L2)
            norm.append(it)
        norm = tuple(norm)
        if not norm:
            raise ValueError("plan_batch needs at least one item")
        dts = "auto" if (isinstance(dtype, str) and dtype == "auto") else _dtype_str(dtype)
        g = max(1, int(pad_to or 1))
        mesh, dp, rs = self._resolve_shard(shard_spec)
        if rs is not None:
            g = math.lcm(g, rs.size)
        dev = resolve_device(device)
        cache_key = (norm, kind, dts, backend, tune, requires_grad, donate, g, dev.type,
                     mesh, dp)
        hit = self._batched.get(cache_key)
        if hit is not None:
            return hit
        groups: dict = {}
        for i, it in enumerate(norm):
            groups.setdefault(it.signature(), []).append(i)
        buckets = []
        for idxs in groups.values():
            it0 = norm[idxs[0]]
            known = [norm[i].size for i in idxs if norm[i].size]
            p = self.plan(it0.L1, it0.L2, it0.Lout, kind=kind, Ls=it0.Ls,
                          batch_hint=sum(known) if known else None, dtype=dts,
                          backend=backend, options=dict(it0.options) or None,
                          tune=tune, requires_grad=requires_grad, device=dev)
            buckets.append(_Bucket(item_ids=tuple(idxs), plan=p))
        bp = self._batched[cache_key] = BatchedGauntPlan(
            kind=kind, dtype=dts, items=norm, buckets=tuple(buckets), granularity=g,
            donate=donate, shard=shard_spec, _rows=rs)
        return bp

    @staticmethod
    def _resolve_shard(shard_spec) -> tuple:
        """A `ShardSpec` -> (mesh, dp axes, `RowShard`); (None, (), None)
        when it is None or finds no mesh or no data-parallel axis."""
        if shard_spec is None:
            return None, (), None
        mesh, dp = shard_spec.resolve()
        if mesh is None or not dp:
            return None, (), None
        from ..distributed.sharding import row_shard

        return mesh, dp, row_shard(mesh, dp)

    def calibrate_fused(self, L: int = 6, B: int = 64, dtype: str = "float32",
                        device=None) -> dict:
        """Measure the cost model's skinny-matmul factor on ``device`` (None:
        cuda).

        Times the collocation product in torch ops (``fused_torch``) and the
        ``dense_einsum`` baseline on one pairwise workload (L, L, L) at B
        rows, median of 5 synchronised calls each, derives the per-MAC cost
        ratio the cost model needs to rank the two as measured (clamped to
        [0.25, 16]), installs it under the per-dtype key ('fused_skinny' for
        f32, 'fused_skinny:<dtype>' otherwise) as measured, flushes it to the
        autotune cache, and returns the record.  One timing run; it never
        runs under a CUDA-graph capture."""
        dts = _dtype_str(dtype)
        if dts not in _REGISTRY["fused_torch"].dtypes:
            raise ValueError(f"fused_torch has no {dts} mode to calibrate")
        dev = resolve_device(device)
        cuda = dev.type == "cuda"
        if cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("calibrate_fused times on the device: it cannot run "
                               "while this stream is capturing a CUDA graph")
        key = PlanKey(L, L, L, kind="pairwise", batch_hint=B, dtype=dts, device=dev.type)
        args = _synthetic_inputs(key, dev)
        self.timing_runs += 1
        times = {}
        with torch.no_grad(), _uncounted():
            for name in ("fused_torch", "dense_einsum"):
                apply = _REGISTRY[name].build(key)
                apply(*args)
                ts = []
                for _ in range(5):
                    if cuda:
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    apply(*args)
                    if cuda:
                        torch.cuda.synchronize(dev)
                    ts.append(time.perf_counter() - t0)
                times[name] = sorted(ts)[len(ts) // 2]
        d = num_coeffs(L)
        G = ((2 * (2 * L) + 2) ** 2 + 127) // 128 * 128
        macs_fused = B * G * (3 * d)
        macs_dense = B * d * d * d
        factor = (times["fused_torch"] / macs_fused) / (times["dense_einsum"] / macs_dense)
        factor = float(min(16.0, max(0.25, factor)))
        ck = _calib_key(dts)
        set_calibration(**{ck: factor, ck + "_measured": True})
        self._autoflush()
        return {"factor": round(factor, 3),
                "fused_torch_us": round(times["fused_torch"] * 1e6, 1),
                "dense_einsum_us": round(times["dense_einsum"] * 1e6, 1),
                "L": L, "B": B, "dtype": dts, "device": dev.type}

    def select(self, key: PlanKey, tune: str = "heuristic",
               requires_grad: bool = True) -> str:
        """Pick the backend for ``key`` by cost model or measurement."""
        eligible = [b for b in _REGISTRY.values() if b.eligible(key, requires_grad)]
        if not eligible:
            raise ValueError(f"no eligible backend for {key}")
        if tune == "measure":
            self._maybe_load_cache()
            hit = self._measured.get(key)
            # a pick measured under requires_grad=False may be gradless
            if hit is not None and any(b.name == hit for b in eligible):
                return hit
            name = self._measure(key, eligible)
            if name is not None:
                self._measured[key] = name
                self._measured_t[key] = self.measured_times[key][name]
                self._autoflush()
                return name
        return min(eligible, key=lambda b: b.cost(key)).name

    def _measure(self, key: PlanKey, eligible: list) -> str | None:
        """Time the eligible backends on synthetic inputs on the key's device
        (`_time_calls`: CUDA events on the card, median of 20) -> the
        fastest, or None when nothing was timed (the caller falls back to
        the cost model and caches nothing).

        A kernel backend is timed only on CUDA, and an error from it
        propagates: a kernel that fails to build or launch must not hide
        behind a plain backend.  Any other backend that raises loses the
        measurement, as in the reference; its error is kept in
        ``measure_errors``."""
        dev = torch.device(key.device)
        args = _synthetic_inputs(key, dev)
        self.timing_runs += 1
        times, spread, errors = {}, {}, {}
        with torch.no_grad(), _uncounted():
            for spec in eligible:
                if spec.kernel and dev.type != "cuda":
                    continue
                if spec.kernel:
                    apply = _build_plan_apply(spec, key)
                    ts = _time_calls(lambda: apply(*args), dev)
                else:
                    try:
                        apply = _build_plan_apply(spec, key)
                        ts = _time_calls(lambda: apply(*args), dev)
                    except Exception as e:  # noqa: BLE001 — a broken plain backend loses
                        errors[spec.name] = f"{type(e).__name__}: {e}"
                        continue
                times[spec.name] = float(np.median(ts))
                spread[spec.name] = (min(ts), max(ts))
        if errors:
            self.measure_errors[key] = errors
        if not times:
            return None
        self.measured_times[key] = times
        self.measured_spread[key] = spread
        return min(times, key=times.get)

    def plans(self) -> list:
        return list(self._plans.values())

    def clear(self) -> None:
        """Drop every plan and measurement and restore the default cost
        calibration: a cleared engine behaves like a fresh one."""
        self._plans.clear()
        self._batched.clear()
        self._chains.clear()
        self._measured.clear()
        self._measured_t.clear()
        self.measured_times.clear()
        self.measured_spread.clear()
        self.measure_errors.clear()
        reset_calibration()
        # a cleared engine loads its persistent cache again at the next miss
        self._cache_loaded = False
        self.cache_unusable = False
        self.timing_runs = 0
        self.chain_timing_s.clear()

    # -- chain plans -------------------------------------------------------

    def plan_chain(self, Ls, Lout: int | None = None, *,
                   conversion: str | None = None, conv: str | None = None,
                   dtype="float32", tree: bool = True, donate: bool = False,
                   shard_spec=None, backend: str | None = None,
                   tune: str = "heuristic", batch_hint: int | None = None,
                   share_hint: tuple | None = None, entry_hint: tuple | None = None,
                   out_hint: str = "sh", gate: bool = False, device=None) -> ChainPlan:
        """Plan  x_1 (x) ... (x) x_n  (n >= 2, Lout defaults to sum(Ls)).

        ``backend`` pins one of `CHAIN_BACKENDS`; otherwise ``tune='measure'``
        times the device's candidates at ``batch_hint`` rows on ``device``
        (default cuda), and ``tune='heuristic'`` picks 'tree'.  An explicit
        ``conversion`` or ``conv`` pins 'tree' too: they parameterize its
        spectral pass.  ``conversion`` is 'half' (Hermitian half grids, the
        default) or 'dense'; ``conv`` the grid combination, 'rfft' (half
        grids only), 'fft' or 'direct', by default 'direct' for a 2-operand
        chain of max degree <= 4 (half grids) and 'rfft' otherwise ('direct'
        or 'fft' by `spectral_default` for dense grids); ``tree=False`` folds
        the grids left to right instead of the divide-and-conquer tree.
        ``donate=True`` is accepted and donates nothing (the chain never
        writes its operands).  ``shard_spec`` (a `ShardSpec`) splits the
        chain's rows over the mesh's data-parallel ranks (`_shard_chain`);
        an unpinned sharded chain is 'tree' and never consults the measured
        cache, as in the reference, and a pinned backend ('fused_hopper':
        the chain kernel) runs on each rank's rows.  None of these options enters
        the measured key (`chain_measure_key`).  The hints
        make the measurement look like the real call: ``share_hint`` gives
        per-operand duplicate-group indices (a shared operand is timed as
        shared), ``entry_hint`` ('sh' | 'fourier' per operand) times
        'fourier' slots as resident half-grid Reps, and ``out_hint``
        ('sh' | 'fourier') times every candidate with that exit ('looped',
        which has no resident exit, is left out for 'fourier').
        ``gate=True`` plans the models' gate as a chain-interior stage.
        ``dtype='auto'`` with ``tune='measure'`` times the chain at f32 and
        bf16 and keeps bf16 only where it wins by more than the f32 spread
        (float32 otherwise; `_resolve_auto`).
        """
        Ls = tuple(int(L) for L in Ls)
        if len(Ls) < 2:
            raise ValueError("chain plans need at least 2 operands")
        Lout = sum(Ls) if Lout is None else int(Lout)
        if Lout > sum(Ls):
            raise ValueError("Lout cannot exceed the total degree (Gaunt selection rule)")
        mesh, dp, rs = self._resolve_shard(shard_spec)
        pinned_spectral = conversion is not None or conv is not None
        if conversion is None:
            conversion = "half"
        if conversion not in ("dense", "half"):
            raise ValueError(f"chain conversion must be 'dense'|'half', got {conversion!r}")
        if conv is None:
            if conversion == "half":
                conv = "direct" if (len(Ls) == 2 and max(Ls) <= 4) else "rfft"
            else:
                conv = spectral_default(*Ls)
        if conv not in ("rfft", "fft", "direct"):
            raise ValueError(f"chain conv must be 'rfft'|'fft'|'direct', got {conv!r}")
        if conv == "rfft" and conversion != "half":
            raise ValueError("conv='rfft' operates on half grids (conversion='half')")
        if backend is not None and backend not in CHAIN_BACKENDS:
            raise ValueError(f"unknown chain backend {backend!r} "
                             f"(expected one of {CHAIN_BACKENDS})")
        if tune not in ("heuristic", "measure"):
            raise ValueError(f"unknown tune {tune!r} (expected 'heuristic'|'measure')")
        if entry_hint is not None:
            entry_hint = tuple(entry_hint)
            if len(entry_hint) != len(Ls) or any(e not in ("sh", "fourier")
                                                 for e in entry_hint):
                raise ValueError(f"entry_hint must be {len(Ls)} entries of "
                                 f"'sh'|'fourier', got {entry_hint!r}")
        if out_hint not in ("sh", "fourier"):
            raise ValueError(f"out_hint must be 'sh'|'fourier', got {out_hint!r}")
        if share_hint is not None:
            share_hint = tuple(int(g) for g in share_hint)
            if len(share_hint) != len(Ls):
                raise ValueError(f"share_hint must have {len(Ls)} group indices, "
                                 f"got {share_hint!r}")
        hints = (batch_hint, share_hint, entry_hint, out_hint)
        if isinstance(dtype, str) and dtype == "auto":
            # a sharded chain measures nothing: 'auto' is float32 there
            dts = ("float32" if rs is not None else
                   self._select_chain_dtype(Ls, Lout, hints, gate, tune, device))
        else:
            dts = _dtype_str(dtype)
        if backend is None:
            backend = (self._select_chain(Ls, Lout, dts, hints, gate, resolve_device(device))
                       if tune == "measure" and not pinned_spectral and rs is None
                       else "tree")
        key = (Ls, Lout, conversion, conv, dts, tree, backend, gate, mesh, dp)
        hit = self._chains.get(key)
        if hit is not None:
            return hit
        if backend in ("tree", "looped"):
            apply = (_build_chain(Ls, Lout, conversion, conv, dts, tree) if backend == "tree"
                     else _build_chain_looped(Ls, Lout, dts, self))
            if gate:
                apply = _wrap_chain_gate(apply, Lout)
        else:
            apply = _build_chain_fused(Ls, Lout, dts, kernel=backend == "fused_hopper",
                                       gate=gate)
        if rs is not None:
            apply = _shard_chain(apply, rs)
        cp = self._chains[key] = ChainPlan(Ls, Lout, dts, backend, gate, apply,
                                           conversion, conv, tree, (mesh, dp))
        return cp

    @staticmethod
    def chain_measure_key(Ls: tuple, Lout: int, dts: str, batch_hint: int | None,
                          share_hint: tuple | None, gate: bool, device,
                          entry_hint: tuple | None = None, out_hint: str = "sh") -> tuple:
        """The measured-selection key: (Ls, Lout, dtype, rows, share, gate,
        device type), rows quantized to a power-of-two ladder capped at
        16384 as in the reference.  The operands' and exit's bases join the
        key only when they differ from all-'sh' / 'sh' (the way the
        reference appends its gate entry only when gated), so every all-SH
        key, and every cache file holding one, stays as it was."""
        if batch_hint is not None:
            q = 8
            while q < min(batch_hint, 16384):
                q *= 2
            batch_hint = q
        share = tuple(share_hint) if share_hint else tuple(range(len(Ls)))
        key = (Ls, Lout, dts, batch_hint, share, bool(gate), torch.device(device).type)
        entries = tuple(entry_hint) if entry_hint else ("sh",) * len(Ls)
        if any(e != "sh" for e in entries) or out_hint != "sh":
            key += (("entries", entries), ("out", out_hint))
        return key

    def measured_pick(self, key: tuple) -> str | None:
        """The chain backend cached for ``key`` (a `chain_measure_key`), or
        None when the key was never measured."""
        return self._measured.get(key)

    @contextlib.contextmanager
    def pinned_chain(self, key: tuple, backend: str):
        """Serve chain ``key`` (a `chain_measure_key`) with ``backend`` inside
        the block, whatever was measured for it; the measured pick, or its
        absence, is back when the block ends, however it ends."""
        had, old = key in self._measured, self._measured.get(key)
        self._measured[key] = backend
        self._pins.add(key)
        try:
            yield
        finally:
            self._pins.discard(key)
            if had:
                self._measured[key] = old
            else:
                self._measured.pop(key, None)

    def _synthetic_chain(self, Ls, key, device, gated: bool):
        """Seeded operands for timing a chain key — one tensor per (share
        group, degree, basis), 'fourier' slots as resident half-grid Reps —
        and, for a gated chain, a synthetic gate MLP sized so the per-row
        scalar path costs what the models' [rows, C] @ [C, hidden] gate head
        costs (as the reference; at the accumulation dtype, as the models'
        gate weights are)."""
        from .rep import Rep

        B, share = key[3] or 256, key[4]
        entries = dict(key[7:]).get("entries", ("sh",) * len(Ls))
        rng = np.random.default_rng(0)
        rd = _RDTYPE[key[2]]
        made: dict = {}
        xs = []
        for L, g, e in zip(Ls, share, entries):
            if (g, L, e) not in made:
                x = torch.as_tensor(rng.normal(size=(B, num_coeffs(L))), dtype=rd,
                                    device=device)
                made[(g, L, e)] = Rep.from_sh(x, L).to_fourier("half") if e == "fourier" else x
            xs.append(made[(g, L, e)])
        acc = _ACC[key[2]]
        gp = ({"w1": torch.as_tensor(rng.normal(size=(B, 16)), dtype=acc, device=device),
               "w2": torch.as_tensor(rng.normal(size=(16, B)), dtype=acc, device=device)}
              if gated else None)
        return xs, gp

    def _cached_or_timing(self, key, device):
        """The cached pick for ``key`` (the persisted table is read first),
        or None when it must be timed; timing under a CUDA-graph capture
        raises (it synchronises the device, and a guess would bake an
        unmeasured pick into the graph)."""
        self._maybe_load_cache()
        hit = self._measured.get(key)
        if hit is not None:
            return hit
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"measured key {key} is not measured and this stream is capturing a "
                f"CUDA graph: measure it before the capture (the serve engine's "
                f"warmup seeds every bucket's keys)")
        return None

    def _record(self, key, times: dict, spread: dict, pick=None) -> str:
        """Cache a timed selection (the fastest unless ``pick`` is given)
        and flush it to the autotune cache."""
        best = min(times, key=times.get) if pick is None else pick
        self._measured[key] = best
        self._measured_t[key] = min(times.values())
        self.measured_times[key] = times
        self.measured_spread[key] = spread
        self._autoflush()
        return best

    def _select_chain(self, Ls, Lout, dts, hints, gate, device) -> str:
        batch_hint, share_hint, entry_hint, out_hint = hints
        key = self.chain_measure_key(Ls, Lout, dts, batch_hint, share_hint, gate, device,
                                     entry_hint, out_hint)
        hit = self._cached_or_timing(key, device)
        if hit is not None:
            return hit
        self.timing_runs += 1
        kernel = "fused_hopper" if device.type == "cuda" else "fused_torch"
        names = ("tree", "looped", kernel) if out_hint == "sh" else ("tree", kernel)
        xs, gp = self._synthetic_chain(Ls, key, device, gate)
        times, spread = {}, {}
        with torch.no_grad(), _uncounted():
            for name in names:
                t0 = time.perf_counter()
                cp = self.plan_chain(Ls, Lout, dtype=dts, backend=name, gate=gate)
                ts = _time_calls(lambda: cp.apply(xs, out_basis=out_hint, gate_params=gp),
                                 device)
                self.chain_timing_s[name] = (self.chain_timing_s.get(name, 0.0)
                                             + time.perf_counter() - t0)
                times[name] = float(np.median(ts))
                spread[name] = (min(ts), max(ts))
        return self._record(key, times, spread)

    def _resolve_auto(self, key, tune: str, device, default: str, candidates: dict) -> str:
        """One measured 'auto' policy — a plan's or a chain's storage dtype,
        the gate's grid-vs-SH — cached under ``key``.  Under
        ``tune='measure'`` a miss times each of ``candidates`` (name -> a
        builder returning the zero-argument call to time, or None when that
        candidate cannot run here) and keeps ``default`` unless another is
        faster by more than the default's measured spread: its median below
        the default's fastest call.  Heuristic tuning resolves to
        ``default`` without timing or caching, and so does a miss where
        nothing could be timed."""
        hit = self._cached_or_timing(key, device)
        if hit is not None:
            return hit
        if tune != "measure":
            return default
        self.timing_runs += 1
        times, spread = {}, {}
        with torch.no_grad(), _uncounted():
            for name, build in candidates.items():
                fn = build()
                if fn is None:
                    continue
                ts = _time_calls(fn, device)
                times[name] = float(np.median(ts))
                spread[name] = (min(ts), max(ts))
        if not times:
            return default
        best = min(times, key=times.get)
        floor = spread[default][0] if default in times else math.inf
        return self._record(key, times, spread, pick=best if times[best] < floor else default)

    def _select_chain_dtype(self, Ls, Lout, hints, gate, tune, device) -> str:
        """Resolve a chain's ``dtype='auto'`` (`_resolve_auto`): the chain at
        f32 and at bf16, each on its measured pick, timed on the same
        synthetic operands; cached under the key's 'auto' sibling."""
        batch_hint, share_hint, entry_hint, out_hint = hints
        dev = torch.device("cuda" if device is None else device)

        def key(dts):
            return self.chain_measure_key(Ls, Lout, dts, batch_hint, share_hint, gate, dev,
                                          entry_hint, out_hint)

        def sibling(dts):
            def build():
                cp = self.plan_chain(Ls, Lout, dtype=dts, tune="measure",
                                     batch_hint=batch_hint, share_hint=share_hint,
                                     entry_hint=entry_hint, out_hint=out_hint, gate=gate,
                                     device=dev)
                xs, gp = self._synthetic_chain(Ls, key(dts), dev, gate)
                return lambda: cp.apply(xs, out_basis=out_hint, gate_params=gp)
            return build

        return self._resolve_auto(key("auto"), tune, dev, "float32",
                                  {d: sibling(d) for d in ("float32", "bfloat16")})

    def select_gate(self, Ls, Lout: int | None = None, *, dtype="float32",
                    batch_hint: int | None = None, entry_hint: tuple | None = None,
                    out_hint: str = "sh", share_hint: tuple | None = None,
                    tune: str = "measure", device=None) -> str:
        """The measured grid-vs-SH gate policy of one chain workload, the
        decision behind ``grid_gate='auto'`` -> 'grid' | 'sh'.

        Times the gate-fused chain (``plan_chain(..., gate=True)``) against
        the ungated chain followed by the SH gate epilogue; for a resident
        ``out_hint='fourier'`` the epilogue pays the exit -> gate -> re-entry
        round trip that the fusion elides.  Each chain runs its own measured
        pick, and 'grid' wins only by more than the spread of 'sh'
        (`_resolve_auto`).  Cached under the chain's measure key plus
        ("gate", "policy") and persisted with the autotune table;
        ``tune='heuristic'`` resolves to 'sh' without timing."""
        from .rep import Rep

        Ls = tuple(int(L) for L in Ls)
        Lout = sum(Ls) if Lout is None else int(Lout)
        dev = resolve_device(device)
        hints = (batch_hint, share_hint, entry_hint, out_hint)
        if isinstance(dtype, str) and dtype == "auto":
            dts = self._select_chain_dtype(Ls, Lout, hints, True, tune, dev)
        else:
            dts = _dtype_str(dtype)
        key = self.chain_measure_key(Ls, Lout, dts, batch_hint, share_hint, False, dev,
                                     entry_hint, out_hint) + (("gate", "policy"),)
        kw = dict(dtype=dts, tune="measure", batch_hint=batch_hint, entry_hint=entry_hint,
                  out_hint=out_hint, share_hint=share_hint, device=dev)

        def grid():
            cp = self.plan_chain(Ls, Lout, gate=True, **kw)
            xs, gp = self._synthetic_chain(Ls, key, dev, True)
            return lambda: cp.apply(xs, out_basis=out_hint, gate_params=gp)

        def sh():
            cp = self.plan_chain(Ls, Lout, **kw)
            xs, gp = self._synthetic_chain(Ls, key, dev, True)
            if out_hint == "fourier":
                def fn():
                    rep = cp.apply(xs, out_basis="fourier")
                    return Rep.from_sh(_gate_sh(gp, rep.to_sh().data), rep.L).to_fourier("half")
                return fn
            return lambda: _gate_sh(gp, cp.apply(xs))

        return self._resolve_auto(key, tune, dev, "sh", {"grid": grid, "sh": sh})

    def _select_dtype(self, make_key: Callable, tune: str, requires_grad: bool) -> str:
        """Resolve a plan's ``dtype='auto'`` (`_resolve_auto`): the best
        backend of each storage sibling (``make_key(dtype)``), timed on the
        same synthetic inputs; a sibling no backend serves is left out.
        Cached under ``make_key('auto')``."""
        auto_key = make_key("auto")
        dev = torch.device(auto_key.device)

        def sibling(dts):
            def build():
                key = make_key(dts)
                if not any(b.eligible(key, requires_grad) for b in _REGISTRY.values()):
                    return None
                spec = _REGISTRY[self.select(key, tune="measure", requires_grad=requires_grad)]
                apply, args = _build_plan_apply(spec, key), _synthetic_inputs(key, dev)
                return lambda: apply(*args)
            return build

        return self._resolve_auto(auto_key, tune, dev, "float32",
                                  {d: sibling(d) for d in ("float32", "bfloat16")})


@contextlib.contextmanager
def _uncounted():
    """Leave the conversion counters as they were: the conversions a timed
    measurement runs are not the caller's computation."""
    from . import rep as _rep

    snap = dict(_rep._COUNTS)
    try:
        yield
    finally:
        _rep._COUNTS.update(snap)


_MEASURE_REPS = 20


def _time_calls(fn, device, reps: int = _MEASURE_REPS) -> list[float]:
    """Seconds per call of ``fn`` over ``reps`` calls after two warm calls
    (the first builds and launches).  On CUDA each call runs between two
    events on an idle stream, so the time holds the host's launches and the
    device's work; on the CPU it is the host clock."""
    cuda = device.type == "cuda"
    for _ in range(2):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return ts


def _synthetic_inputs(key: PlanKey, device) -> tuple:
    """Seeded operands for timing ``key`` at ``batch_hint`` rows (256 when
    unset), as the reference makes them."""
    B = key.batch_hint or 256
    rd = _RDTYPE[key.dtype]
    rng = np.random.default_rng(0)

    def r(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=rd, device=device)

    if key.kind == "pairwise":
        return r(B, num_coeffs(key.L1)), r(B, num_coeffs(key.L2))
    if key.kind == "conv_filter":
        v = rng.normal(size=(B, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return r(B, num_coeffs(key.L1)), torch.as_tensor(v, dtype=torch.float32,
                                                         device=device)
    if key.kind == "manybody":
        return ([r(B, num_coeffs(L)) for L in key.opt("Ls")],)
    # channel_mix: small representative channel counts
    C1 = C2 = E = 4
    return (r(B, C1, num_coeffs(key.L1)), r(B, C2, num_coeffs(key.L2)),
            r(C1, C2, E))


_ENGINE = GauntEngine()


def get_engine() -> GauntEngine:
    """The process-wide engine (plans and measurements are cached on it)."""
    return _ENGINE


def plan(*args, **kw) -> GauntPlan:
    """Module-level shorthand for ``get_engine().plan(...)``."""
    return _ENGINE.plan(*args, **kw)


def plan_chain(*args, **kw) -> ChainPlan:
    return _ENGINE.plan_chain(*args, **kw)


def plan_batch(*args, **kw) -> BatchedGauntPlan:
    """Module-level shorthand for ``get_engine().plan_batch(...)``."""
    return _ENGINE.plan_batch(*args, **kw)
