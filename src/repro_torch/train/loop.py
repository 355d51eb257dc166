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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch import nn

from ..checkpoint import CheckpointManager
from ..config import TrainConfig
from ..distributed.fault_tolerance import Heartbeat, PreemptionGuard, StragglerMonitor
from ..optim import adamw, apply_updates, clip_by_global_norm, cosine_schedule

__all__ = ["TrainState", "make_train_step", "train_loop"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: Any
    step: int = 0


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, optimizer=None):
    """loss_fn(model, batch) -> (loss, metrics dict).  Returns
    (step(model, opt_state, batch) -> (opt_state, metrics), optimizer); the
    step updates the model's parameters in place, and ``opt_state`` too
    (it returns the same dicts, updated).

    With ``tcfg.microbatch > 1`` the batch's leading axis splits into that
    many microbatches, taken in order; the loss and the float32 gradients
    accumulate divided by their count, as in the reference."""
    opt = optimizer or adamw(
        cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps),
        tcfg.b1, tcfg.b2, tcfg.eps, tcfg.weight_decay,
    )

    def grads_of(model, params: dict, batch):
        loss, metrics = loss_fn(model, batch)
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

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if tcfg.microbatch and tcfg.microbatch > 1:
            mb = tcfg.microbatch
            loss = 0.0
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                loss_i, metrics, g = grads_of(model, params, part)
                loss = loss + loss_i / mb
                grads = {k: grads[k] + g[k].float() / mb for k in grads}
        else:
            loss, metrics, grads = grads_of(model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        opt_state = update(opt_state, grads, params)
        return opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return step, opt


def train_loop(
    loss_fn: Callable,
    model: nn.Module,
    data_iter,
    tcfg: TrainConfig,
    ckpt_dir: str | None = None,
    hooks: dict | None = None,
):
    """Run ``tcfg.total_steps`` steps with the fault-tolerance plumbing ->
    (TrainState, history).

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
    opt_state = opt.init(dict(model.named_parameters()))
    start_step = 0

    mgr = CheckpointManager(ckpt_dir, keep=tcfg.keep_checkpoints) if ckpt_dir else None
    if mgr is not None and mgr.latest_step() is not None:
        s = mgr.latest_step()
        restored, extra = mgr.restore(s, {"model": model.state_dict(), "opt": opt_state},
                                      device=device)
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
                mgr.save(step + 1, {"model": model.state_dict(), "opt": opt_state},
                         extra=extra, blocking=preempted or last)
            if preempted:
                break
    finally:
        if guard is not None:
            guard.uninstall()
    if mgr:
        mgr.wait()
    return TrainState(model, opt_state, step + 1), history
