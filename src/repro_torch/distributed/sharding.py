"""Partitioning rules and row-parallel dispatch over a `DeviceMesh`, the
port of the reference's ``repro.distributed.sharding``.

Scheme: the batch shards over ('pod', 'data'); FSDP shards parameters over
'data'; tensor parallelism (Megatron column/row) and expert parallelism use
'model'.  The rules are candidate lists per tensor dim resolved against the
actual shapes: a dim that no candidate divides falls back to the next
candidate or to replication (qwen2-moe's 60 experts on a 16-way model axis
shard d_ff instead).

A spec here is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, each ``None``, a mesh-axis name or a tuple of names.
`placements` turns it into the `torch.distributed.tensor` placement list of
a mesh (``Shard(d)`` on each mesh dim that splits tensor dim ``d``,
``Replicate()`` elsewhere), which `DTensor` takes.  The rule functions take
a `DeviceMesh` with named dims or a `MeshShape` (names and sizes, no
process group), so a production-size layout can be computed, and compared
with the reference's, in a plain process.

Parameter keys: the port's language models keep one tree entry per layer
("layers.3.attn.wq.w") where the reference stacks the layers on a leading
scan axis ("layers/attn/wq/w").  `rule_key` drops the layer index and joins
with '/', and the rule is resolved on the per-layer shape, so a port leaf
gets the reference's spec without its leading ``None``.

Row-parallel dispatch (the Gaunt engine's sharded plans): every operand
leaf of a row layout has the flat row axis first.  `scatter_rows` keeps
this rank's block of rows and `gather_rows` concatenates every rank's
block; each is the other's adjoint (`torch.autograd.Function`s whose
backward calls the other's ``apply``), so forces, and the force loss's
second derivative, differentiate through them to any order.

Parameter gathering (the sharded train step): `gather_param` turns a
`DTensor` parameter into its whole weight, and its adjoint reduce-scatters
the gradient back onto the placements; `gather_blocks` gives a language
model's forward a tree whose per-layer entries gather when read.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping

import torch

__all__ = ["DP_AXES", "MeshShape", "axis_sizes", "choose_pspec", "param_pspec",
           "batch_pspec", "cache_pspec", "placements", "param_shardings",
           "batch_shardings", "cache_shardings",
           "set_activation_mesh", "get_activation_mesh", "constrain_batch",
           "constrain_ep_weights", "dp_axes", "dp_size", "row_pspec", "row_sharding",
           "rule_key", "RowShard", "row_shard", "scatter_rows", "gather_rows",
           "gather_param", "sharded_step", "GatheredBlock", "gather_blocks"]

DP_AXES = ("pod", "data")  # batch axes (pod missing on single-pod meshes)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's named dims and sizes with no process group behind it: what
    the rules need to lay out a production mesh in one process."""

    axis_names: tuple
    shape: tuple


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` (named dims) or a `MeshShape`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.shape)))


def _axes_in(mesh, names) -> tuple:
    sizes = axis_sizes(mesh)
    return tuple(n for n in names if n in sizes)


# --- activation mesh ----------------------------------------------------------
# The launcher registers its mesh here; model code then asks for it at the
# points the reference pins activation layouts (MoE dispatch, the layer
# stack), and `engine.ShardSpec()` with no mesh takes it.
_ACT_MESH = None


def set_activation_mesh(mesh) -> None:
    global _ACT_MESH
    _ACT_MESH = mesh


def get_activation_mesh():
    """The mesh registered by the launcher (None outside launched runs)."""
    return _ACT_MESH


# --- row-parallel helpers -------------------------------------------------------


def dp_axes(mesh, prefer: tuple = DP_AXES) -> tuple:
    """The data-parallel axes of ``mesh`` (the subset of ``prefer`` it has)."""
    return _axes_in(mesh, prefer)


def dp_size(mesh, axes: tuple | None = None) -> int:
    """Device count across the data-parallel axes (1 if none)."""
    axes = dp_axes(mesh) if axes is None else axes
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes)) if axes else 1


def _entry(axes: tuple):
    """A spec entry of ``axes``: one name bare, several as a tuple (as
    jax's PartitionSpec canonicalizes them)."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def row_pspec(ndim: int, axes: tuple) -> tuple:
    """The spec sharding dim 0 over ``axes`` and replicating the rest."""
    if not axes:
        return (None,) * ndim
    return (_entry(tuple(axes)),) + (None,) * (ndim - 1)


def row_sharding(mesh, ndim: int, axes: tuple | None = None) -> list:
    """The placements of a row layout on ``mesh`` (dim 0 over the dp axes)."""
    axes = dp_axes(mesh) if axes is None else axes
    return placements(row_pspec(ndim, axes), mesh)


def placements(spec: tuple, mesh) -> list:
    """A spec -> the mesh's placement list: ``Shard(d)`` on every mesh dim
    named in entry ``d`` of the spec, ``Replicate()`` on the others.  A
    tensor dim split over several mesh dims splits in mesh-dim order, as
    the reference's tuple entries do (they list the axes in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return out


def constrain_ep_weights(w):
    """The expert weights [E, a, b] in their compute form.  The reference
    pins them to 'model' on E so XLA gathers the weights, not the dispatch
    activations.  The port's steps gather every weight into a plain tensor
    before its block computes (FSDP-style, `train.loop`), so the compute form
    is already the whole tensor: no layout to pin, and no number changes."""
    return w


def constrain_batch(x, *trailing):
    """The reference's batch pin on dim 0.  In the port a rank holds its own
    rows of the batch already (`batch_shardings` splits it before the step),
    so there is nothing to redistribute: the hint returns ``x`` unchanged,
    with or without a registered mesh."""
    return x


def choose_pspec(shape, mesh, prefs: list) -> tuple:
    """prefs[i]: ordered candidate mesh-axis names for dim i ([] replicates).
    The first candidate that exists in the mesh, is larger than 1, divides
    the dim and is not used yet wins."""
    used: set = set()
    spec = []
    sizes = axis_sizes(mesh)
    for dim, cands in zip(shape, list(prefs) + [[]] * (len(shape) - len(prefs))):
        pick = None
        for c in cands:
            if c in sizes and c not in used and dim % sizes[c] == 0 and sizes[c] > 1:
                pick = c
                used.add(c)
                break
        spec.append(pick)
    return tuple(spec)


# per-leaf-name rules: per-dim candidate lists for the per-layer shape
_RULES: list = [
    # embeddings / unembedding
    (r"embed/embedding$", [["model"], ["data"]]),
    (r"unembed/w$", [["data"], ["model"]]),
    (r"dec_pos$", [[], ["data"]]),
    # attention (col-parallel qkv, row-parallel o)
    (r"(attn|xattn)/wq/w$", [["data"], ["model"]]),
    (r"(attn|xattn)/wk/w$", [["data"], ["model"]]),
    (r"(attn|xattn)/wv/w$", [["data"], ["model"]]),
    (r"(attn|xattn)/w[qkv]/b$", [["model"]]),
    (r"(attn|xattn)/wo/w$", [["model"], ["data"]]),
    # dense mlp
    (r"mlp/w_(up|gate)/w$", [["data"], ["model"]]),
    (r"mlp/w_down/w$", [["model"], ["data"]]),
    # moe: EP on model if divisible, else shard ff on model + d on data
    (r"moe/router/w$", [["data"], []]),
    (r"moe/we_(gate|up)$", [["model"], ["data"], ["model"]]),
    (r"moe/we_down$", [["model", "data"], ["model"], ["data"]]),
    (r"moe/shared/w_(up|gate)/w$", [["data"], ["model"]]),
    (r"moe/shared/w_down/w$", [["model"], ["data"]]),
    # mamba2
    (r"in_proj/w$", [["data"], ["model"]]),
    (r"out_proj/w$", [["model"], ["data"]]),
    (r"conv_w$", [[], ["model"]]),
    (r"conv_b$", [["model"]]),
    # rwkv6
    (r"tm/w[rkvg]/w$", [["data"], ["model"]]),
    (r"tm/wo/w$", [["model"], ["data"]]),
    (r"tm/maa_w1$", [["data"], []]),
    (r"tm/maa_w2$", [[], [], ["data"]]),
    (r"tm/decay_w1$", [["data"], []]),
    (r"tm/decay_w2$", [[], ["data"]]),
    (r"cm/cm_k/w$", [["data"], ["model"]]),
    (r"cm/cm_v/w$", [["model"], ["data"]]),
    (r"cm/cm_r/w$", [["data"], ["model"]]),
    # zamba2 glue
    (r"cat_proj/w$", [["data"], ["model"]]),
]

# layout variants:
# default      : FSDP('data') x TP('model'), EP on 'model' where divisible
# dp_heavy     : parameters replicated over 'model' (FSDP over 'data' only)
# moe_expert_tp: expert weights not FSDP-gathered; d_ff over 'data' within
#                each expert
_MOE_EXPERT_TP = [
    (r"moe/we_(gate|up)$", [["model"], [], ["data"]]),
    (r"moe/we_down$", [["model"], ["data"], []]),
]
LAYOUTS = ("default", "dp_heavy", "moe_expert_tp")


def rule_key(key: str) -> str:
    """A port parameter path -> the reference's rule key: dotted to slashed,
    the per-layer index dropped ("layers.3.attn.wq.w" -> "layers/attn/wq/w")."""
    return "/".join(p for p in key.split(".") if not p.isdigit())


def param_pspec(key: str, shape, mesh, layout: str = "default") -> tuple:
    """The spec of the port parameter ``key`` of (per-layer) ``shape``."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (expected one of {LAYOUTS})")
    rk = rule_key(key)
    shape = tuple(shape)
    rules = _MOE_EXPERT_TP + _RULES if layout == "moe_expert_tp" else _RULES
    for pat, prefs in rules:
        if re.search(pat, rk):
            if layout == "dp_heavy":
                prefs = [[c for c in cand if c != "model"] for cand in prefs]
            return choose_pspec(shape, mesh, prefs)
    # default: replicate small things; FSDP-shard big 2D+ tensors on 'data'
    if len(shape) >= 2 and math.prod(shape) >= 1 << 20:
        return choose_pspec(shape, mesh, [["data"], ["model"]])
    return (None,) * len(shape)


def _map_tree(fn, tree, path: str = ""):
    """fn(path, leaf) over nested dicts, lists and tuples; a leaf is
    anything with a ``shape``; an ``nn.Module`` maps over its named
    parameters."""
    if hasattr(tree, "named_parameters"):
        return {k: fn(k, p) for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, f"{path}.{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(param_tree, mesh, layout: str = "default"):
    """The tree of placement lists matching ``param_tree``."""
    return _map_tree(lambda k, leaf: placements(param_pspec(k, leaf.shape, mesh, layout),
                                                mesh), param_tree)


def batch_pspec(shape, mesh) -> tuple:
    """Dim 0 (the batch) over ('pod', 'data') when it divides, else
    replicated."""
    if len(shape) == 0:
        return ()
    dp = _axes_in(mesh, DP_AXES)
    if dp and shape[0] % dp_size(mesh, dp) == 0:
        return (_entry(dp),) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def batch_shardings(batch_tree, mesh):
    """The tree of placement lists of a batch (see `batch_pspec`)."""
    return _map_tree(lambda k, leaf: placements(batch_pspec(tuple(leaf.shape), mesh), mesh),
                     batch_tree)


def cache_pspec(shape, mesh) -> tuple:
    """KV and recurrent caches, [L, B, S, KV, hd]-style: the batch over
    ('pod', 'data'), then heads over 'model', then the sequence over
    'model'; a long single-sequence cache also spreads its sequence over
    'data'."""
    nd = len(shape)
    if nd < 3:
        return (None,) * nd
    dp = _axes_in(mesh, DP_AXES)
    sizes = axis_sizes(mesh)
    n_dp = dp_size(mesh, dp)
    spec: list = [None] * nd
    used: set = set()
    if dp and shape[1] % n_dp == 0:
        spec[1] = _entry(dp)
        used.update(dp)
    elif "data" in sizes and shape[1] % sizes["data"] == 0:
        spec[1] = "data"
        used.add("data")
    if "model" in sizes and sizes["model"] > 1:
        if nd >= 4 and shape[3] % sizes["model"] == 0:
            spec[3] = "model"
        elif shape[2] % sizes["model"] == 0:
            spec[2] = "model"
    if spec[1] is None and "data" not in used and "data" in sizes:
        if shape[2] % (sizes["data"] * sizes.get("model", 1)) == 0 and spec[2] == "model":
            spec[2] = ("data", "model")
        elif spec[2] is None and shape[2] % sizes["data"] == 0:
            spec[2] = "data"
    return tuple(spec)


def cache_shardings(cache_tree, mesh):
    """The tree of placement lists of a cache (see `cache_pspec`)."""
    return _map_tree(lambda k, leaf: placements(cache_pspec(tuple(leaf.shape), mesh), mesh),
                     cache_tree)


# --- row scatter / gather -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's place in the data-parallel group of a mesh: the process
    group over the dp axes (fixed coordinates on the others), this rank's
    index in it and its size."""

    group: object
    index: int
    size: int


_ROW_GROUPS: dict = {}


def row_shard(mesh, axes: tuple) -> RowShard:
    """The `RowShard` of this rank over ``axes`` of ``mesh``.  One axis is
    the mesh's own group; several are flattened into one group (made once
    per mesh, collectively: every rank makes every group, in one order)."""
    key = (id(mesh), tuple(axes))
    hit = _ROW_GROUPS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
        rs = RowShard(group, mesh.get_local_rank(axes[0]), mesh.mesh.shape[names.index(axes[0])])
    else:
        dims = [names.index(a) for a in axes]
        others = [i for i in range(len(names)) if i not in dims]
        n = math.prod(mesh.mesh.shape[d] for d in dims)
        rows = mesh.mesh.permute(*others, *dims).reshape(-1, n).tolist()
        me = dist.get_rank()
        rs = None
        for ranks in rows:
            g = dist.new_group(ranks)
            if me in ranks:
                rs = RowShard(g, ranks.index(me), n)
    _ROW_GROUPS[key] = (mesh, rs)
    return rs


def _all_gather_rows(x: torch.Tensor, rs: RowShard) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    real = torch.view_as_real(x) if x.is_complex() else x
    parts = [torch.empty_like(real) for _ in range(rs.size)]
    dist.all_gather(parts, real, group=rs.group)
    out = torch.cat(parts, dim=0)
    return torch.view_as_complex(out) if x.is_complex() else out


class _ScatterRows(torch.autograd.Function):
    """Keep this rank's block of rows of a replicated tensor; the adjoint
    gathers every rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, x, rs):
        ctx.rs = rs
        n = x.shape[0] // rs.size
        return x[rs.index * n:(rs.index + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return _GatherRows.apply(g, ctx.rs), None


class _GatherRows(torch.autograd.Function):
    """Concatenate every rank's block of rows (in rank order); the adjoint of
    a replicated cotangent is this rank's block of it."""

    @staticmethod
    def forward(ctx, x, rs):
        ctx.rs = rs
        return _all_gather_rows(x, rs)

    @staticmethod
    def backward(ctx, g):
        return _ScatterRows.apply(g, ctx.rs), None


def scatter_rows(x: torch.Tensor, rs: RowShard) -> torch.Tensor:
    """This rank's block of dim 0 (which ``rs.size`` divides)."""
    return _ScatterRows.apply(x, rs)


def gather_rows(x: torch.Tensor, rs: RowShard) -> torch.Tensor:
    """Every rank's block of dim 0, concatenated in rank order."""
    return _GatherRows.apply(x, rs)


# --- FSDP-style parameter gathering -------------------------------------------
# The sharded train step keeps each parameter as a `DTensor` on its
# placements and gathers it into a whole plain tensor only where a block
# reads it, so every kernel sees plain tensors and a device holds its
# shards plus the whole weights of the block that computes.  The gather's
# adjoint reduce-scatters the whole-weight gradient of this rank's rows
# straight back onto the placements.

_STEP = None  # the `sharded_step` in progress, if any


class _GatherParam(torch.autograd.Function):
    """A parameter's local shard -> the whole weight: an all-gather over
    each mesh dim that shards it (innermost first, as `DTensor` nests
    them).  The adjoint scales the whole-weight cotangent by ``scale`` and,
    over each mesh dim in ``reduce_dims``, sums it: a reduce-scatter where
    that dim shards the weight, an all-reduce where it replicates it;
    elsewhere a sharding dim keeps this rank's block.  Mesh dims of one
    rank move nothing.  Plain c10d collectives, no `DTensor` dispatch: one
    call a sharded dim, whatever the leaf."""

    @staticmethod
    def forward(ctx, local, mesh, pl, reduce_dims, scale):
        import torch.distributed as dist

        ctx.spec = (mesh, pl, reduce_dims, scale)
        x = local
        for i in reversed(range(len(pl))):
            n = mesh.size(i)
            if pl[i].is_shard() and n > 1:
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x.contiguous(), group=mesh.get_group(i))
                x = torch.cat(parts, dim=pl[i].dim)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        import torch.distributed as dist

        mesh, pl, reduce_dims, scale = ctx.spec
        g = g * scale
        for i, p in enumerate(pl):
            n = mesh.size(i)
            if n == 1:
                continue
            group = mesh.get_group(i)
            if p.is_shard():
                chunks = [c.contiguous() for c in g.chunk(n, dim=p.dim)]
                if i in reduce_dims:
                    g = torch.empty_like(chunks[0])
                    dist.reduce_scatter(g, chunks, group=group)
                else:
                    g = chunks[mesh.get_local_rank(i)]
            elif i in reduce_dims:
                g = g.contiguous()
                dist.all_reduce(g, group=group)
        return g, None, None, None, None


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """A `DTensor` parameter -> its whole weight as a plain tensor whose
    gradient, taken on this rank's rows, comes back as the mean over the
    data-parallel ranks on ``p``'s placements: to ``p``, or, within a
    `sharded_step`, to the plain shard that step holds for ``p`` (and
    summed over its ``axes``).  A plain tensor passes through.  The shards
    are even (the rules shard only dims that divide)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    sizes = axis_sizes(mesh)
    step = _STEP
    local = None if step is None else step.shards.get(id(p))
    if local is None:
        local = p.to_local()
    axes = dp_axes(mesh) if step is None else _axes_in(mesh, step.axes)
    names = list(sizes)
    scale = 1.0 / math.prod(sizes[a] for a in axes)
    return _GatherParam.apply(local, mesh, tuple(p.placements),
                              frozenset(names.index(a) for a in axes), scale)


class sharded_step:
    """The sharded train step's context for `gather_param`: ``shards``
    maps each `DTensor` parameter to a plain tensor sharing its local
    shard's storage, which the step differentiates (so the step runs no
    `DTensor` op a leaf), and gradients sum over the mesh dims ``axes``
    (the data-parallel ones; 'data' alone when the 'pod' reduction is
    compressed, `collectives.int8_ef_cross_pod_mean`)."""

    def __init__(self, axes: tuple, shards: dict):
        self.axes, self.shards = tuple(axes), {id(p): t for p, t in shards}

    def __enter__(self):
        global _STEP
        self._prev, _STEP = _STEP, self
        return self

    def __exit__(self, *exc):
        global _STEP
        _STEP = self._prev
        return False


def _gather_all(v):
    if isinstance(v, dict):
        return {k: _gather_all(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_gather_all(x) for x in v]
    return gather_param(v)


class GatheredBlock(Mapping):
    """One block of a parameter tree whose `DTensor` leaves are gathered
    whole when read (`gather_param`), and not before: nothing is kept, so
    the whole weights live while the block computes.  Nested dicts read as
    `GatheredBlock`s too; membership and iteration read no weight."""

    __slots__ = ("_tree",)

    def __init__(self, tree: dict):
        self._tree = tree

    def __getitem__(self, k):
        v = self._tree[k]
        if isinstance(v, dict):
            return GatheredBlock(v)
        if isinstance(v, list):
            return [GatheredBlock(x) if isinstance(x, dict) else gather_param(x) for x in v]
        return gather_param(v)

    def __contains__(self, k) -> bool:
        return k in self._tree

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def gather_blocks(tree: dict) -> dict:
    """A language model's parameter tree with `DTensor` leaves -> the tree
    its forward reads: each entry of a per-layer list a `GatheredBlock`
    (its weights gathered when that layer computes), every other entry
    (embeddings, final norm, head, a shared block) gathered whole once.  A
    tree of plain tensors is returned as it is."""
    from torch.distributed.tensor import DTensor

    def any_dtensor(v):
        if isinstance(v, dict):
            return any(any_dtensor(x) for x in v.values())
        if isinstance(v, list):
            return any(any_dtensor(x) for x in v)
        return isinstance(v, DTensor)

    if not any_dtensor(tree):
        return tree
    return {k: [GatheredBlock(x) for x in v] if isinstance(v, list) else _gather_all(v)
            for k, v in tree.items()}
