"""The Gaunt tensor product in torch.

Public API:
    GauntEngine / plan      the plan/dispatch layer over the pairwise backends
    plan_batch              ragged multi-degree workloads, one call per bucket
    plan_chain / ChainPlan  whole chained products (the many-body stage)
    Rep                     basis-tagged activations (sh | fourier | quad)
    conversion_stats        the SH <-> Fourier / quad conversion counters
    GauntTensorProduct      full O(L^3) tensor product (fft / direct / packed / rfft)
    EquivariantConv         x (x) Y(rhat) on the eSCN rotation-aligned path
    manybody_gaunt_product  nu-fold products (one chain plan)
    cg_full_tensor_product  the e3nn-style O(L^6) baseline
    gaunt_einsum_reference  dense real-Gaunt oracle
"""
from .cg import cg_full_tensor_product, gaunt_einsum_reference  # noqa: F401
from .conv import EquivariantConv  # noqa: F401
from .engine import (  # noqa: F401
    ChainPlan,
    GauntEngine,
    GauntPlan,
    available_backends,
    get_engine,
    plan,
    plan_batch,
    plan_chain,
)
from .gaunt import GauntTensorProduct, expand_degree_weights  # noqa: F401
from .irreps import Irreps, num_coeffs  # noqa: F401
from .manybody import manybody_gaunt_product, manybody_selfmix  # noqa: F401
from .rep import Rep, conversion_stats, reset_conversion_stats  # noqa: F401
