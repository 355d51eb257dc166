"""Constant builders, Gaunt stages, chain plans, conv and many-body ops."""
