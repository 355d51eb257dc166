"""Multi-pod dry run, the port of the reference's ``repro.launch.dryrun``:
lay out every (arch x shape x mesh) cell on the production mesh and trace
its step, recording memory per device, FLOPs per device and the collective
schedule, without a GPU and without 256 processes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh single --out results/dryrun_torch.json

A cell joins a fake process group of the production world size
(``init_process_group("fake")``: every collective returns at once), builds
the (16, 16) or (2, 16, 16) `DeviceMesh`, makes the parameters as fake
DTensors (shapes, no storage) with their `param_shardings` placements,
and traces the step this port runs there, through the same gathering as
`train.loop`'s sharded step (`distributed.sharding.gather_blocks`):

* train: the embeddings, final norm and head gathered whole once; each
  layer's weights gathered as it computes, under activation checkpointing,
  and again in its backward, whose whole-weight gradients are
  reduce-scattered onto the placements; the loss on this rank's rows of
  the batch (`batch_shardings`); the clip norm's all-reduce;
* prefill / decode: the same gathering with no backward; the cache laid
  out by `cache_shardings`, gathered onto the batch rows (the step
  computes a row's heads whole), and the step run on this rank's rows.

`CommDebugMode` counts the collectives; a dispatch mode beside it adds up
their bytes (the larger of operand and result, an all-reduce twice, as the
reference counts them); `FlopCounterMode` gives ``flops_per_device``.
``memory`` holds what one device keeps for the step, from the placements:
its shards of the parameters, gradients and optimizer moments, and
``gathered_bytes``, the whole weights it holds at once: the embeddings,
norms and head, plus the largest layer's weights and, in training, that
layer's whole gradients.  ``gathered_bytes`` does not shrink with the
mesh.  ``peak_per_device_gb`` is the step's arguments (which it updates
in place), gradients and gathered weights, without activations: a lower
bound.

Keys with no torch counterpart are ``None``: ``temp_bytes`` and
``alias_bytes`` (XLA's buffer assignment: torch has no compiled program
to ask), ``bytes_per_device`` (XLA's bytes-accessed estimate) and
``compile_s``.

Skips (recorded): long_500k on the pure full-attention archs (it needs
sub-quadratic decode).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

__all__ = ["dryrun_cell", "main"]

# functional collectives (DTensor's) and c10d ones (the train step's gather)
_KINDS = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
          "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
          "allgather_": "all-gather", "reduce_scatter_": "reduce-scatter",
          "allreduce_": "all-reduce", "alltoall_base_": "all-to-all"}


def _collective_recorder():
    """A dispatch mode adding up the bytes of the collectives that pass
    through it -> (mode, {"total_bytes", "by_kind"})."""
    from torch.utils._python_dispatch import TorchDispatchMode

    rec = {"total_bytes": 0.0, "by_kind": {}}

    def nbytes(x):
        if isinstance(x, (list, tuple)):
            return sum(nbytes(y) for y in x)
        return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            kind = _KINDS.get(name)
            if kind is not None and "c10d" in str(func):
                size = max([nbytes(a) for a in args] + [nbytes(out)])
                b = (2.0 if kind == "all-reduce" else 1.0) * size
                rec["by_kind"][kind] = rec["by_kind"].get(kind, 0.0) + b
                rec["total_bytes"] += b
            return out

    return Recorder(), rec


def _local_numel(shape, pl, sizes) -> int:
    n = math.prod(shape)
    for p, size in zip(pl, sizes):
        if p.is_shard():
            n //= size
    return n


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}.{i}" if path else str(i))
    else:
        yield path, tree


def _rebuild(tree, leaves: dict, path=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{path}.{k}" if path else k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{path}.{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return leaves[path]


def _dtensor(x, mesh, pl):
    """A meta DTensor of ``x``'s global shape laid out by ``pl``."""
    from torch.distributed.tensor import DTensor

    sizes = tuple(mesh.mesh.shape)
    shape = list(x.shape)
    for p, size in zip(pl, sizes):
        if p.is_shard():
            shape[p.dim] //= size
    local = torch.empty(shape, dtype=x.dtype, device=x.device)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=x.shape,
                              stride=x.stride())


def _gathered_bytes(p_dt: dict, train: bool) -> int:
    """Whole bytes one device holds at once under `gather_blocks`: every
    parameter outside the per-layer lists, plus the largest layer (twice
    in training: its weights and their whole gradients in its backward)."""
    root, layers = 0, {}
    for k, x in p_dt.items():
        parts = k.split(".")
        n = x.numel() * x.element_size()
        if len(parts) > 1 and parts[1].isdigit():
            layers[parts[0], parts[1]] = layers.get((parts[0], parts[1]), 0) + n
        else:
            root += n
    return root + (2 if train else 1) * max(layers.values(), default=0)


def _bytes(leaves: dict, pl: dict, sizes) -> int:
    """Bytes one device holds of ``leaves`` laid out by ``pl``."""
    return sum(_local_numel(tuple(x.shape), pl[k], sizes) * x.element_size()
               for k, x in leaves.items())


def _placed(leaves: dict, spec_of, mesh) -> dict:
    """{path: placements} of ``leaves`` by ``spec_of(path, leaf)``."""
    from ..distributed.sharding import placements

    return {k: placements(spec_of(k, x), mesh) for k, x in leaves.items()}


def _trace_train(model, ptree, specs, mesh, leaves):
    """The sharded train step on this rank (`train.loop`): the loss and its
    backward on its rows of the batch, reading ``ptree`` (DTensor leaves)
    gathered by block, differentiating plain tensors on each leaf's local
    shard, and the clip norm -> the batch's placements."""
    from ..distributed.sharding import batch_pspec, dp_axes, gather_blocks, sharded_step
    from ..train.loop import sharded_global_norm

    b_pl = _placed(specs, lambda k, v: batch_pspec(tuple(v.shape), mesh), mesh)
    batch = {k: _dtensor(v, mesh, b_pl[k]).to_local() for k, v in specs.items()}
    shards = {k: x.to_local().detach().requires_grad_(True) for k, x in leaves.items()}
    with sharded_step(dp_axes(mesh), [(leaves[k], t) for k, t in shards.items()]):
        loss, _ = model.loss(gather_blocks(ptree), batch)
        grads = torch.autograd.grad(loss, list(shards.values()), allow_unused=True)
    sharded_global_norm({k: torch.zeros_like(x) if g is None else g
                         for (k, x), g in zip(shards.items(), grads)},
                        {k: tuple(x.placements) for k, x in leaves.items()}, mesh)
    return b_pl


def _trace_serve(model, cfg, shape, ptree, specs, mesh, names):
    """The prefill or decode step on this rank's rows -> (cache leaves,
    their placements by `cache_shardings`).  Decode gathers each cache leaf
    onto its batch placement first: the step computes a row's heads whole."""
    from ..distributed.sharding import batch_pspec, cache_pspec, gather_blocks, placements
    from ..models import transformer as T

    tree = specs["cache"] if shape.kind == "decode" else \
        T.init_cache(cfg, shape.global_batch, shape.seq_len, torch.device("cpu"))
    c_dt = dict(_walk(tree))
    c_pl = _placed(c_dt, lambda k, x: cache_pspec(tuple(x.shape), mesh), mesh)
    ptree = gather_blocks(ptree)
    with torch.no_grad():
        if shape.kind == "decode":
            rows = {k: _dtensor(x, mesh, c_pl[k]).redistribute(
                mesh, placements(_batch_only(c_pl[k], names, x.dim()), mesh)).to_local()
                for k, x in c_dt.items()}
            b = next(iter(rows.values())).shape[1]
            tok = torch.zeros((b, 1), dtype=torch.long)
            T.decode_step_inplace(ptree, cfg, _rebuild(tree, rows), tok,
                                  torch.zeros((b,), dtype=torch.long))
        else:
            b_pl = _placed(specs, lambda k, v: batch_pspec(tuple(v.shape), mesh), mesh)
            model.prefill(ptree, {k: _dtensor(v, mesh, b_pl[k]).to_local()
                                  for k, v in specs.items()}, shape.seq_len)
    return c_dt, c_pl


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool, tiny: bool = False,
                layout: str = "default") -> dict:
    """Lay out and trace one cell -> its record (see the module docstring).
    Joins a fake process group of the cell's world size for the call unless
    one is already there.  ``DRYRUN_KV_INT8`` set in the environment traces
    the int8 KV cache, as in the reference."""
    import contextlib

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..config import SHAPES, get_config
    from ..configs import SUBQUADRATIC
    from ..distributed.sharding import param_pspec, set_activation_mesh
    from ..models import transformer as T
    from ..models.api import Model, input_specs
    from . import mesh as _mesh

    cfg = get_config(arch)
    if os.environ.get("DRYRUN_KV_INT8"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if tiny:
        cfg = cfg.reduced()
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and arch not in SUBQUADRATIC and not tiny:
        return {"status": "skipped", "reason": "full-attention arch; long_500k needs "
                "sub-quadratic decode"}
    # the trace runs the blockwise attention's Python loop on fake tensors:
    # blocks of at least 1/8 of the sequence keep it to 36 block pairs a
    # layer (the causal FLOPs it counts grow by 1/8 over 1/2 S^2)
    cfg = dataclasses.replace(cfg, attn_chunk=max(cfg.attn_chunk, shape.seq_len // 8))
    mshape, _ = _mesh.production_shape(multi_pod)
    n_dev = math.prod(mshape)
    with contextlib.ExitStack() as stack:
        if not dist.is_initialized():
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_dev)
            stack.callback(dist.destroy_process_group)
        mesh = _mesh.make_production_mesh(multi_pod=multi_pod)
        set_activation_mesh(mesh)
        stack.callback(set_activation_mesh, None)
        names, sizes = list(mesh.mesh_dim_names), tuple(mesh.mesh.shape)
        # fake CPU tensors: shapes and dtypes, no storage; every wrapper of a
        # kernel takes its plain version, so its math is what is counted
        stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        model = Model(cfg, torch.device("cpu"))
        params = T.init_params(None, cfg, torch.device("cpu"))
        spec_meta = input_specs(cfg, shape)
        specs = _rebuild(spec_meta, {k: torch.empty(x.shape, dtype=x.dtype)
                                     for k, x in _walk(spec_meta)})
        p_dt = dict(_walk(params))
        p_pl = _placed(p_dt, lambda k, x: param_pspec(k, x.shape, mesh, layout), mesh)
        recorder, coll = _collective_recorder()
        flops = FlopCounterMode(display=False)
        t0 = time.time()
        train = shape.kind == "train"
        leaves = {k: _dtensor(x, mesh, p_pl[k]) for k, x in p_dt.items()}
        ptree = _rebuild(params, leaves)
        with CommDebugMode() as comm, recorder, flops:
            if train:
                b_pl = _trace_train(model, ptree, specs, mesh, leaves)
            else:
                c_dt, c_pl = _trace_serve(model, cfg, shape, ptree, specs, mesh, names)
        t_trace = time.time() - t0
        p_bytes = _bytes(p_dt, p_pl, sizes)
        g_bytes = _gathered_bytes(p_dt, train)
        if train:
            # two float32 AdamW moments on the parameters' placements
            o_bytes = 2 * _bytes({k: x.float() for k, x in p_dt.items()}, p_pl, sizes)
            arg = p_bytes + o_bytes + _bytes(specs, b_pl, sizes)
            out = p_bytes + o_bytes
        else:
            o_bytes = 0
            out = _bytes(c_dt, c_pl, sizes)
            arg = p_bytes + out
        held = arg + (p_bytes if train else 0) + g_bytes
        counts = {str(k).split(".")[-1]: int(v) for k, v in comm.get_comm_counts().items()}
    return {
        "status": "ok",
        "layout": layout,
        "arch": arch,
        "attn_chunk": cfg.attn_chunk,
        "shape": shape_name,
        "mesh": "x".join(map(str, mshape)),
        "devices": n_dev,
        "lower_s": round(t_trace, 1),
        "compile_s": None,
        "memory": {
            "argument_bytes": arg,
            "output_bytes": out,
            "temp_bytes": None,
            "alias_bytes": None,
            "peak_per_device_gb": round(held / 2**30, 3),
            "param_bytes": p_bytes,
            "grad_bytes": p_bytes if train else 0,
            "optimizer_bytes": o_bytes,
            "gathered_bytes": g_bytes,
        },
        "cost": {"flops_per_device": float(flops.get_total_flops()),
                 "bytes_per_device": None},
        "collectives": {**coll, "counts": counts},
        "hlo_lines": None,
    }


def _batch_only(pl, names, ndim) -> tuple:
    """A cache leaf's spec keeping only its batch (dim 1) split."""
    spec = [None] * ndim
    axes = tuple(a for a, p in zip(names, pl) if p.is_shard() and p.dim == 1)
    if ndim >= 2 and axes:
        spec[1] = axes
    return tuple(spec)


def main(argv=None) -> int:
    from ..config import SHAPES
    from ..configs import ALL_LM_ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--tiny", action="store_true", help="reduced configs (CI)")
    ap.add_argument("--layout", default="default",
                    help="sharding layout variant (default|dp_heavy|moe_expert_tp)")
    ap.add_argument("--resume", action="store_true", help="skip cells already in --out")
    args = ap.parse_args(argv)

    archs = ALL_LM_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
                if args.layout != "default":
                    key += f"|{args.layout}"
                if key in results and results[key].get("status") in ("ok", "skipped"):
                    continue
                print(f"=== {key}", flush=True)
                try:
                    rec = dryrun_cell(arch, shape, mp, tiny=args.tiny, layout=args.layout)
                except Exception as e:  # noqa: BLE001 — record the cell and go on
                    rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                results[key] = rec
                print(json.dumps({k: v for k, v in rec.items() if k != "trace"})[:600],
                      flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n = {s: sum(1 for r in results.values() if r.get("status") == s)
         for s in ("ok", "skipped", "error")}
    print(f"DONE ok={n['ok']} skipped={n['skipped']} errors={n['error']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
