"""Synthetic datasets of the port, numpy copies of the reference's
``repro.data``: Lennard-Jones clusters (force-field training), charged
N-body trajectories, and the resumable LM token pipeline."""
from .molecules import lj_dataset  # noqa: F401
from .nbody import nbody_dataset  # noqa: F401
from .pipeline import LMTokenPipeline  # noqa: F401
