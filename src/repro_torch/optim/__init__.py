"""Optimizers and learning-rate schedules of the port (the reference's
``repro.optim``)."""
from .optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    lion,
    sgd,
)
from .schedules import constant_schedule, cosine_schedule, linear_schedule  # noqa: F401
