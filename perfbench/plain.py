"""What every family's plain reference shares: the switch of TF32 matrix
products (the control's precision) and AdamW as the port's training step
states it, in plain PyTorch, importing nothing of the port."""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["tf32", "adamw_reference"]


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matrix products on (the control) or off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _cosine_lr(peak: float, warmup: int, total: int, step: int, floor: float = 0.1) -> float:
    """Linear warmup, then cosine decay to floor * peak at ``total``
    (``step`` 1-based)."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))


def adamw_reference(params: dict, loss_of, batches: list, opt: dict):
    """Train ``params`` (name -> tensor) for len(batches) steps on
    ``loss_of(batch, w)``: clip by the global norm, then AdamW with
    decoupled weight decay on leaves of ndim >= 2.  -> (losses, clipped
    gradients of step 1 {name: tensor}, weights after the last step
    {name: tensor})."""
    w = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, first = [], None
    for t, batch in enumerate(batches, start=1):
        loss = loss_of(batch, w)
        names = list(w)
        gs = torch.autograd.grad(loss, [w[k] for k in names])
        norm = torch.sqrt(sum((g ** 2).sum() for g in gs))
        scale = min(1.0, opt["grad_clip"] / max(float(norm), 1e-9))
        grads = {k: g * scale for k, g in zip(names, gs)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        lr = _cosine_lr(opt["lr"], opt["warmup_steps"], opt["total_steps"], t)
        b1, b2 = opt["b1"], opt["b2"]
        with torch.no_grad():
            for k in names:
                g = grads[k]
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                u = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + opt["eps"])
                if w[k].dim() >= 2:
                    u = u + opt["weight_decay"] * w[k]
                w[k] -= lr * u
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in w.items()}
