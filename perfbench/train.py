"""Training cells: the port's ``make_train_step`` on the family's loss
with AdamW.

The mix file gives the data set (the family's ``batches`` read its size,
the batch, and what else they need from it), the loss's parameters and the
``TrainConfig`` fields.  Set-up builds one step object (model, optimizer
state) and drives it through its first ``check_steps`` steps on the
window's own feed: those steps warm it up and are what the reference
follows.  The window then steps the same object for ``seconds``, each
batch moved to the device and the loss read every ``log_every`` steps, as
the port's ``train_loop`` does; it closes with a synchronisation.  With
``trace`` the port's spans (on where ``run.py`` switched them on), reset
where the window opens, are snapshotted where its traced part begins.
"""
from __future__ import annotations

import json
import time

import torch

from . import bench, check
from .trace import Tracer, span

__all__ = ["FAMILY", "run", "adamw_settings"]

# what a training cell calls of its configuration's family, beside bench.FAMILY
FAMILY = ("batches", "loss", "reference_loss", "train_flops")


def adamw_settings(tcfg) -> dict:
    """The optimizer's settings the reference follows, from a TrainConfig."""
    return dict(lr=tcfg.lr, warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps,
                b1=tcfg.b1, b2=tcfg.b2, eps=tcfg.eps, weight_decay=tcfg.weight_decay,
                grad_clip=tcfg.grad_clip)


def run(cell: dict, cfg: dict, family, mix: dict, lim: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, step_factory=None) -> tuple[dict, dict, dict]:
    """One run of a training cell -> (result fields, checks, run record).
    ``step_factory`` (tests only) wraps the program's step."""
    from repro_torch.config import TrainConfig
    from repro_torch.core import engine as ge
    from repro_torch.train.loop import make_train_step

    device = torch.device(device)
    phases = {"start": time.perf_counter() - t_start}
    wts = family.make_weights(cfg, seed, device)
    w0 = {k: v.clone() for k, v in wts.items()}
    model = family.build(cfg, wts, device)
    tcfg = TrainConfig(**mix["optimizer"])

    def loss_fn(m, batch):
        return family.loss(m, batch, mix), {}

    step_fn, opt = make_train_step(loss_fn, tcfg)
    if step_factory is not None:
        step_fn = step_factory(step_fn)
    opt_state = opt.init(dict(model.named_parameters()))
    batch = family.batches(mix, seed)

    def feed(i):
        return {k: torch.as_tensor(v, device=device) for k, v in batch(i).items()}

    phases["model_data"] = time.perf_counter() - t_start
    losses, grad = [], None
    for i in range(mix["check_steps"]):
        opt_state, metrics = step_fn(model, opt_state, feed(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad = {k: v.detach().clone() / (1 - tcfg.b1) for k, v in opt_state["mu"].items()}
    delta = {k: p.detach().clone() - w0[k] for k, p in model.named_parameters()}
    if trace:
        Tracer.warm(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["checked_steps"] = time.perf_counter() - t_start
    print("perfbench: set-up s since start " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()}), flush=True)
    eng = ge.get_engine()
    timing_setup = eng.timing_runs
    spans = bench.port_spans()
    if spans is not None:
        spans.reset()
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(device) if trace else None
    t0 = time.perf_counter()
    t_close = t0 + seconds
    trace_from = t_close - min(mix["trace_seconds"], seconds / 2) if trace else None
    i, steps, marks, snap = mix["check_steps"], 0, {}, None
    while True:
        now = time.perf_counter()
        if now >= t_close:
            break
        if tracer is not None and tracer.t0 is None and now >= trace_from:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            marks.update(t=time.perf_counter(), steps=steps)
            if spans is not None:
                snap = {"totals": spans.totals(), "steps": steps}
            tracer.start()
        with span("train_step"):
            opt_state, metrics = step_fn(model, opt_state, feed(i))
        i += 1
        steps += 1
        if steps % tcfg.log_every == 0:
            with span("loss_read"):
                float(metrics["loss"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    if tracer is not None and tracer.t0 is not None:
        tracer.stop()
        marks.update(steps_end=steps)
    timing_window = eng.timing_runs - timing_setup
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"perfbench: engine timing_runs {eng.timing_runs} (set-up {timing_setup}, "
          f"window {timing_window})", flush=True)
    rec = {"kind": "train", "setup_s": setup_s, "window_s": t_end - t0, "steps": steps,
           "t0": t0, "marks": marks, "family": family, "cfg": cfg, "mix": mix, "trace": None,
           "spans": snap, "memory_peak_bytes": peak}
    if tracer is not None and tracer.t0 is not None:
        rec["trace"] = tracer.summary()
    del model, opt_state, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    batches = [{k: torch.as_tensor(v) for k, v in batch(j).items()}
               for j in range(mix["check_steps"])]
    ref = check.reference_train(family, cfg, w0, batches, adamw_settings(tcfg), mix,
                                torch.float64, device)
    readings = check.train_readings({"losses": losses, "grad": grad, "delta": delta}, ref)
    print(f"perfbench: check of {len(batches)} steps {time.perf_counter() - t_check:.2f} s",
          flush=True)
    checks = {k: {"value": readings[k], "limit": lim[k]} for k in lim}
    result = {"correct": check.verdict(readings, lim), "attempted": steps, "failed": 0}
    return result, checks, rec
