"""Optimizers of the port, after the reference's ``repro.optim.optimizers``:
plain functions over named tensors, so the state is a tree of tensors that
checkpoints leaf by leaf and maps one to one onto the reference's.

    opt = adamw(cosine_schedule(3e-4, 100, 1000))
    params = dict(model.named_parameters())
    state = opt.init(params)                      # {"mu", "nu", "step"}
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)                # in place

The optimizer state is float32 whatever the parameter dtype (the
mixed-precision convention); ``step`` is a 0-d int32 tensor.  Where this
differs from ``torch.optim``:

* the learning rate of an update is ``lr_fn(step)`` at the 1-based step
  being taken (``torch.optim.lr_scheduler.LambdaLR`` gives step k the
  value for k - 1);
* weight decay is decoupled and applies only to parameters with ndim >= 2,
  from the parameter before the update (``torch.optim.AdamW`` decays every
  parameter of its group);
* `clip_by_global_norm` scales by ``min(1, max_norm / max(norm, 1e-9))``
  (``torch.nn.utils.clip_grad_norm_`` uses ``max_norm / (norm + 1e-6)``);
* Lion has no ``torch.optim`` counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["Optimizer", "adamw", "lion", "sgd", "clip_by_global_norm", "apply_updates",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable    # params -> state
    update: Callable  # (grads, state, params) -> (updates, state)


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm of every leaf together, summed in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (grads scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, n


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> None:
    """p <- p + u, summed in float32, in place."""
    for k, p in params.items():
        p.copy_((p.float() + updates[k]).to(p.dtype))


def _zeros(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _next_step(state) -> tuple[int, torch.Tensor]:
    step = int(state["step"]) + 1
    return step, torch.tensor(step, dtype=torch.int32)


def _bias_correction(b: float, step: int) -> float:
    """1 - b^step at float32, as the reference's jnp arithmetic."""
    return float(np.float32(1) - np.float32(b) ** np.float32(step))


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with decoupled weight decay.  lr_fn: step -> lr."""

    def init(params):
        return {"mu": _zeros(params), "nu": _zeros(params),
                "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params):
        step, step_t = _next_step(state)
        lr = lr_fn(step)
        b1c, b2c = _bias_correction(b1, step), _bias_correction(b2, step)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            m = b1 * state["mu"][k] + (1 - b1) * g
            v = b2 * state["nu"][k] + (1 - b2) * g * g
            u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            p = params[k]
            if p.dim() >= 2:
                u = u + weight_decay * p.float()
            updates[k], mu[k], nu[k] = -lr * u, m, v
        return updates, {"mu": mu, "nu": nu, "step": step_t}

    return Optimizer(init, update)


def lion(lr_fn, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.1) -> Optimizer:
    """Lion (sign of the interpolated momentum), decoupled weight decay on
    ndim >= 2 parameters."""

    def init(params):
        return {"mu": _zeros(params), "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params):
        step, step_t = _next_step(state)
        lr = lr_fn(step)
        updates, mu = {}, {}
        for k, g in grads.items():
            g, m, p = g.float(), state["mu"][k], params[k]
            u = torch.sign(b1 * m + (1 - b1) * g)
            if p.dim() >= 2:
                u = u + weight_decay * p.float()
            updates[k], mu[k] = -lr * u, b2 * m + (1 - b2) * g
        return updates, {"mu": mu, "step": step_t}

    return Optimizer(init, update)


def sgd(lr_fn, momentum: float = 0.9) -> Optimizer:
    """SGD with heavy-ball momentum: mu <- momentum mu + g, u = -lr mu."""

    def init(params):
        return {"mu": _zeros(params), "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params):
        step, step_t = _next_step(state)
        lr = lr_fn(step)
        mu = {k: momentum * state["mu"][k] + g.float() for k, g in grads.items()}
        return {k: -lr * m for k, m in mu.items()}, {"mu": mu, "step": step_t}

    return Optimizer(init, update)
