"""Learning-rate schedules as step -> lr functions (the reference's
``repro.optim.schedules``), computed in float32 as the reference's jnp
arithmetic is.  ``step`` is the 1-based step the optimizer is taking."""
from __future__ import annotations

import numpy as np

__all__ = ["cosine_schedule", "linear_schedule", "constant_schedule"]

_f32 = np.float32


def _ramp(peak_lr: float, warmup: int, total: int, step):
    """(s, warmup ramp value, t in [0, 1] past the warmup) at float32."""
    s = _f32(step)
    warm = _f32(peak_lr) * s / _f32(max(warmup, 1))
    t = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)), _f32(0), _f32(1))
    return s, warm, t


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``."""
    def lr(step) -> float:
        s, warm, t = _ramp(peak_lr, warmup, total, step)
        cos = _f32(peak_lr) * (_f32(floor) + _f32(1 - floor) * _f32(0.5)
                               * (_f32(1) + np.cos(_f32(np.pi) * t)))
        return float(warm if s < warmup else cos)

    return lr


def linear_schedule(peak_lr: float, warmup: int, total: int):
    """Linear warmup, then a linear decay to 0 at ``total``."""
    def lr(step) -> float:
        s, warm, t = _ramp(peak_lr, warmup, total, step)
        return float(warm if s < warmup else _f32(peak_lr) * (_f32(1) - t))

    return lr


def constant_schedule(lr_value: float):
    return lambda step: float(_f32(lr_value))
