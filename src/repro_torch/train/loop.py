"""Training loop, after the reference's ``repro.train.loop``: a step with
gradient accumulation, global-norm clip and AdamW, checkpoint, resume,
heartbeat, preemption and straggler hooks.

The loop trains an ``nn.Module`` in place: ``loss_fn(model, batch) ->
(loss, metrics)`` where the reference takes a params pytree (a language
model trains as `models.api.LMModule`, whose ``loss`` is ``Model.loss``).
Batches go to the model's device (its parameters' device: explicit when
the model is built, CUDA by default); an LM batch's int32 token and label
ids become the model's int64 ids in ``Model.loss``.  The step runs eagerly;
it is not captured.

The step donates the optimizer state, as the reference's jitted step
donates its buffers: each parameter's update is taken and applied in turn,
and its new moments replace the old ones in the state's dicts at once.  So
a float32 parameter costs at most 20 bytes at the step's peak (itself, its
gradient before and after the clip, two moments), not the 28 of a whole new
state beside the old one and every update at once: what lets RWKV6-3B
(3.1e9 parameters: 62 GB at 20 B, 87 GB at 28) train on one NVIDIA H100
80GB HBM3.  The numbers are the same: every optimizer here updates each
parameter on its own.

Sharded (``mesh`` given): FSDP-style.  The module's parameters become
`DTensor`s on their `param_shardings` placements, each rank holding its
shards alone, and so does the optimizer state; the batch splits by
`batch_shardings` (each rank takes its rows).  A weight is gathered whole
into a plain tensor where a block reads it, so every kernel sees plain
tensors: a language model (`LMModule`) gathers each layer's weights as that
layer computes, under activation checkpointing, so a layer's whole weights
live during its forward and again during its backward, and its
whole-weight gradients are reduce-scattered onto the placements as its
backward ends (`distributed.sharding.gather_blocks`); its embeddings, final
norm and head are gathered once for the step.  Any other module computes
on all its weights gathered for the step.  The gradients land as the mean
over the data-parallel ranks; the global-norm clip sums over every shard;
the optimizer updates each rank's shards in place.  The logged loss is the
global batch's mean.  The 'model' axis holds parameter shards but computes
no Megatron split: its ranks compute their rows whole.  With
``tcfg.grad_compression='int8_ef'`` and a 'pod' axis, the backward sums
over 'data' only and `collectives.int8_ef_cross_pod_mean` takes the mean
over 'pod', its error feedback (`TrainState.ef`) carried from step to step
and checkpointed.  A ``shard_data`` model is refused: its calls split rows
that every rank must hold alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn

from ..checkpoint import CheckpointManager
from ..config import TrainConfig
from ..distributed.fault_tolerance import Heartbeat, PreemptionGuard, StragglerMonitor
from ..optim import adamw, apply_updates, clip_by_global_norm, cosine_schedule
from ..spans import span

__all__ = ["TrainState", "make_train_step", "train_loop"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: Any
    step: int = 0
    ef: Any = None  # the int8 error feedback of a compressed sharded run


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, optimizer=None):
    """loss_fn(model, batch) -> (loss, metrics dict).  Returns
    (step(model, opt_state, batch) -> (opt_state, metrics), optimizer); the
    step updates the model's parameters in place, and ``opt_state`` too
    (it returns the same dicts, updated).

    With ``tcfg.microbatch > 1`` the batch's leading axis splits into that
    many microbatches, taken in order; the loss and the float32 gradients
    accumulate divided by their count, as in the reference.  The step's
    stages are spans (`repro_torch.spans`): ``loss``, ``param_grad``,
    ``clip``, ``optimizer``."""
    opt = optimizer or adamw(
        cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps),
        tcfg.b1, tcfg.b2, tcfg.eps, tcfg.weight_decay,
    )

    def grads_of(model, params: dict, batch):
        on = next(iter(params.values()), None)
        with span("loss", on):
            loss, metrics = loss_fn(model, batch)
        with span("param_grad", on):
            gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), gs)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def update(opt_state, grads: dict, params: dict):
        """The optimizer's update, parameter by parameter, each applied at
        once and its new state written into ``opt_state``'s dicts (donated:
        the old leaf is freed as it is replaced)."""
        new_step = opt_state["step"]
        for k in list(grads):
            sub = {n: {k: s[k]} if isinstance(s, dict) else s for n, s in opt_state.items()}
            upd, sub = opt.update({k: grads.pop(k)}, sub, {k: params[k]})
            apply_updates({k: params[k]}, upd)
            for n, s in sub.items():
                if isinstance(s, dict):
                    opt_state[n][k] = s[k]
                else:
                    new_step = s
        opt_state["step"] = new_step
        return opt_state

    def loss_and_grads(model, params, batch):
        if tcfg.microbatch and tcfg.microbatch > 1:
            mb = tcfg.microbatch
            loss = 0.0
            grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                loss_i, metrics, g = grads_of(model, params, part)
                loss = loss + loss_i / mb
                grads = {k: grads[k] + g[k].float() / mb for k in grads}
        else:
            loss, metrics, grads = grads_of(model, params, batch)
        return loss, metrics, grads

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, metrics, grads = loss_and_grads(model, params, batch)
        on = next(iter(params.values()), None)
        with span("clip", on):
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        with span("optimizer", on):
            opt_state = update(opt_state, grads, params)
        return opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    step.loss_and_grads = loss_and_grads
    step.update = update
    return step, opt


class _Sharded:
    """The sharded state and step of `train_loop` on ``mesh`` (see the
    module docstring): the module's parameters and the optimizer state as
    `DTensor`s on their placements, the int8 error feedback too."""

    def __init__(self, model, mesh, shardings, tcfg: TrainConfig, opt, step_fn):
        from torch.distributed.tensor import DTensor, distribute_tensor

        from ..distributed.collectives import ef_state_init
        from ..distributed.sharding import param_shardings

        if getattr(getattr(model, "cfg", None), "shard_data", False):
            raise ValueError(
                "a shard_data model splits the rows of each call over the activation mesh, "
                "which holds only when every rank gives it the same rows; the sharded "
                "train loop gives each rank its own rows: train it with shard_data=False")
        if tcfg.grad_compression not in ("none", "int8_ef"):
            raise ValueError(f"unknown grad_compression {tcfg.grad_compression!r}")
        self.mesh, self.tcfg, self.step_fn = mesh, tcfg, step_fn
        self.names = list(mesh.mesh_dim_names)
        shardings = shardings or {}
        pl = shardings.get("params") or param_shardings(model, mesh)
        self.batch_pl = shardings.get("batch")
        # each parameter becomes a DTensor holding this rank's shard alone
        for prefix, mod in model.named_modules():
            for n, p in list(mod._parameters.items()):
                if p is None or isinstance(p, DTensor):
                    continue
                k = f"{prefix}.{n}" if prefix else n
                local = distribute_tensor(p.detach(), mesh, pl[k], src_data_rank=None) \
                    .to_local().clone(memory_format=torch.contiguous_format)
                mod._parameters[n] = nn.Parameter(
                    DTensor.from_local(local, mesh, pl[k], run_check=False, shape=p.shape,
                                       stride=p.stride()), requires_grad=p.requires_grad)
        self.params = dict(model.named_parameters())
        # the step differentiates and updates plain tensors sharing each
        # parameter's local storage and keeps the optimizer state as plain
        # shards (`opt_state` wraps them), so it runs no DTensor op per leaf
        with torch.no_grad():
            self.shards = {k: p.to_local().detach().requires_grad_(p.requires_grad)
                           for k, p in self.params.items()}
        self.placements = {k: tuple(p.placements) for k, p in self.params.items()}
        self.state = opt.init(self.shards)
        # the 'pod' reduction compressed: gradients sum over 'data' only in
        # the backward, then int8_ef_cross_pod_mean takes the pod mean
        self.compress = tcfg.grad_compression == "int8_ef" and "pod" in self.names
        self.ef = ef_state_init(self.params) if self.compress else None

    @property
    def opt_state(self) -> dict:
        """The optimizer state with DTensor leaves on the parameters'
        placements."""
        from torch.distributed.tensor import DTensor

        def one(k, t):
            p = self.params[k]
            return DTensor.from_local(t, self.mesh, p.placements, run_check=False,
                                      shape=p.shape, stride=p.stride())
        return {n: {k: one(k, t) for k, t in v.items()} if isinstance(v, dict) else v
                for n, v in self.state.items()}

    def state_tree(self, model) -> dict:
        tree = {"model": model.state_dict(), "opt": self.opt_state}
        if self.compress:
            tree["ef"] = self.ef
        return tree

    def shardings_of(self, tree):
        """Placement lists of `state_tree`'s leaves (replicated where a leaf
        is a plain tensor)."""
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(tree, dict):
            return {k: self.shardings_of(v) for k, v in tree.items()}
        if isinstance(tree, DTensor):
            return list(tree.placements)
        return [Replicate()] * len(self.names)

    @torch.no_grad()
    def load(self, model, restored: dict) -> None:
        """Take a restored `state_tree` (DTensor leaves on this mesh)."""
        params = dict(model.named_parameters())
        for k, p in params.items():
            p.to_local().copy_(restored["model"][k].to_local())
        model.load_state_dict({k: v.full_tensor() for k, v in restored["model"].items()
                               if k not in params}, strict=False)
        self.state = _locals(restored["opt"])
        if self.compress:
            self.ef = restored["ef"]

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of the batch, by `batch_shardings`."""
        from torch.distributed.tensor import distribute_tensor

        from ..distributed.sharding import batch_shardings

        pl = self.batch_pl or batch_shardings(batch, self.mesh)
        return {k: distribute_tensor(v, self.mesh, pl[k], src_data_rank=None).to_local()
                for k, v in batch.items()}

    @contextlib.contextmanager
    def _whole(self, model):
        """A module that reads its parameters as attributes computes on
        them gathered whole for the step (one block: the whole model); a
        module that gathers by block (`LMModule.gathers_blocks`) is left as
        it is."""
        from torch.distributed.tensor import DTensor

        from ..distributed.sharding import gather_param

        swapped = []
        if not getattr(model, "gathers_blocks", False):
            for mod in model.modules():
                for n, p in list(mod._parameters.items()):
                    if isinstance(p, DTensor):
                        swapped.append((mod, n, p))
                        mod._parameters[n] = gather_param(p)
        try:
            yield
        finally:
            for mod, n, p in swapped:
                mod._parameters[n] = p

    # -- the step --------------------------------------------------------------
    def step(self, model, batch: dict) -> dict:
        from torch.distributed.tensor import DTensor

        from ..distributed.collectives import int8_ef_cross_pod_mean
        from ..distributed.sharding import dp_axes, sharded_step

        axes = ("data",) if self.compress else dp_axes(self.mesh)
        pairs = [(self.params[k], t) for k, t in self.shards.items()]
        with sharded_step(axes, pairs), self._whole(model):
            loss, metrics, grads = self.step_fn.loss_and_grads(model, self.shards,
                                                                self.local_batch(batch))
        if self.compress:
            grads = {k: DTensor.from_local(g, self.mesh, self.placements[k], run_check=False,
                                           shape=self.params[k].shape,
                                           stride=self.params[k].stride())
                     for k, g in grads.items()}
            grads, self.ef = int8_ef_cross_pod_mean(grads, self.ef, self.mesh)
            grads = _locals(grads)
        gnorm = sharded_global_norm(grads, self.placements, self.mesh)
        scale = torch.clamp(self.tcfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        with torch.no_grad():
            local_g = {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}
            self.state = self.step_fn.update(self.state, local_g, self.shards)
        world = dist.get_world_size()
        out = {}
        for k, v in dict(metrics, loss=loss).items():
            v = v.detach().float().clone()
            dist.all_reduce(v)
            out[k] = v / world
        return dict(out, grad_norm=gnorm)


def sharded_global_norm(grads: dict, placements: dict, mesh) -> torch.Tensor:
    """The global norm of gradients held as local shards (plain tensors on
    ``placements``) over every shard: each rank's sum of squares of its
    shards, each divided by the number of ranks that hold that same shard,
    summed over the world (one all-reduce)."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    for k, g in grads.items():
        copies = math.prod(mesh.size(i) for i, p in enumerate(placements[k])
                           if p.is_replicate())
        total = total + g.float().square().sum() / copies
    dist.all_reduce(total)
    return total.sqrt()


def _locals(tree):
    """The local shards of a dict (nested one level) of DTensors."""
    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    return tree.to_local() if hasattr(tree, "to_local") else tree


def train_loop(
    loss_fn: Callable,
    model: nn.Module,
    data_iter,
    tcfg: TrainConfig,
    ckpt_dir: str | None = None,
    hooks: dict | None = None,
    mesh=None,
    shardings: dict | None = None,
):
    """Run ``tcfg.total_steps`` steps with the fault-tolerance plumbing ->
    (TrainState, history).

    ``mesh`` (a `DeviceMesh` with named dims) runs the sharded step (see the
    module docstring); ``shardings`` may give its placements,
    ``{"params": {name: placements}, "batch": {key: placements}}`` (by
    default `param_shardings` of the model and `batch_shardings` of each
    batch).  Every rank of the mesh calls the loop with the same model and
    the same batches.  From then on the model's parameters are `DTensor`s
    (``p.full_tensor()`` gathers one), and the returned state's
    ``opt_state`` holds DTensors.

    Resumes from the latest committed checkpoint in ``ckpt_dir`` if there
    is one: parameters, optimizer state and the data iterator's state
    (``data_iter.state()`` / ``restore``).  Checkpoints every
    ``checkpoint_every`` steps (asynchronously), at the last step and on
    preemption (blocking).  ``history`` holds the metrics every
    ``log_every`` steps and at the last.  hooks: ``log`` (called with each
    history entry), ``heartbeat_path``, ``preemption`` (default True:
    SIGTERM checkpoints and stops; the handler is removed on return)."""
    hooks = hooks or {}
    device = next(model.parameters()).device
    step_fn, opt = make_train_step(loss_fn, tcfg)
    sharded = None if mesh is None else _Sharded(model, mesh, shardings, tcfg, opt, step_fn)
    opt_state = opt.init(dict(model.named_parameters())) if sharded is None else None
    start_step = 0

    def state_tree():
        if sharded is not None:
            return sharded.state_tree(model)
        return {"model": model.state_dict(), "opt": opt_state}

    mgr = CheckpointManager(ckpt_dir, keep=tcfg.keep_checkpoints) if ckpt_dir else None
    if mgr is not None and mgr.latest_step() is not None:
        s = mgr.latest_step()
        if sharded is not None:
            tree = state_tree()
            restored, extra = mgr.restore(s, tree, shardings=sharded.shardings_of(tree),
                                          mesh=mesh)
            sharded.load(model, restored)
        else:
            restored, extra = mgr.restore(s, state_tree(), device=device)
            model.load_state_dict(restored["model"])
            opt_state = restored["opt"]
        start_step = s
        if hasattr(data_iter, "restore") and "pipeline" in extra:
            data_iter.restore(extra["pipeline"])

    guard = PreemptionGuard().install() if hooks.get("preemption", True) else None
    hb = Heartbeat(hooks["heartbeat_path"]) if "heartbeat_path" in hooks else None
    straggler = StragglerMonitor()
    history = []
    step = start_step - 1  # if already past total_steps (resume), no-op
    try:
        for step in range(start_step, tcfg.total_steps):
            batch = (data_iter.next_batch() if hasattr(data_iter, "next_batch")
                     else next(data_iter))
            batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
            t0 = time.time()
            if sharded is not None:
                metrics = sharded.step(model, batch)
            else:
                opt_state, metrics = step_fn(model, opt_state, batch)
            if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
                history.append({"step": step + 1, **{k: float(v) for k, v in metrics.items()}})
                if hooks.get("log"):
                    hooks["log"](history[-1])
            straggler.record(step, time.time() - t0)
            if hb:
                hb.beat(step)
            preempted = guard is not None and guard.should_exit
            last = step == tcfg.total_steps - 1
            if mgr is not None and ((step + 1) % tcfg.checkpoint_every == 0
                                    or last or preempted):
                extra = {"pipeline": data_iter.state()} if hasattr(data_iter, "state") else {}
                mgr.save(step + 1, state_tree(), extra=extra, blocking=preempted or last)
            if preempted:
                break
    finally:
        if guard is not None:
            guard.uninstall()
    if mgr:
        mgr.wait()
    ef = None
    if sharded is not None:
        opt_state, ef = sharded.opt_state, sharded.ef
        dist.barrier()  # rank 0's last checkpoint is on disk for every rank
    return TrainState(model, opt_state, step + 1, ef), history
