"""Equivariant models and parameter conversion from the reference."""
