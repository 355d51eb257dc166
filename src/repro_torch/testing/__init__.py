"""Test support for the port: seeded random generators, rotation helpers,
numpy float64 reference products (:mod:`repro_torch.testing.oracles`) and
the per-precision tolerance tiers (:mod:`repro_torch.testing.precision`),
as the reference's ``repro.testing`` has them; and the MoE near-tie rules
of the bf16 checks (:mod:`repro_torch.testing.routing`)."""
from .oracles import (  # noqa: F401
    cg_product_oracle,
    gaunt_product_oracle,
    random_angles,
    random_array,
    random_irreps,
    random_unit_vectors,
    rotate_irreps,
    rotation_matrix,
    wigner_D,
)
from .precision import assert_close, tol_for  # noqa: F401
from .routing import RouterLog, near_tie_bound, pick_flips  # noqa: F401

__all__ = [
    "random_array",
    "random_irreps",
    "random_unit_vectors",
    "random_angles",
    "rotation_matrix",
    "wigner_D",
    "rotate_irreps",
    "gaunt_product_oracle",
    "cg_product_oracle",
    "tol_for",
    "assert_close",
    "near_tie_bound",
    "RouterLog",
    "pick_flips",
]
