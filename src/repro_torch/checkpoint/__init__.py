"""Checkpointing of the port (the reference's ``repro.checkpoint``)."""
from .manager import CheckpointManager  # noqa: F401
