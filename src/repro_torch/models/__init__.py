"""Equivariant models and parameter conversion from the reference, and the
language models' API (`models.api`), re-exported here as the reference does."""
from .api import Model, build_model, count_params, input_specs  # noqa: F401
