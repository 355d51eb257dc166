"""Hand-written CUDA kernels (sources in csrc/), their build and wrappers.

The package re-exports the public wrappers of `kernels.ops`, as the
reference's ``repro.kernels`` does; ``gaunt_tp_fused_torch`` is the
counterpart of its ``gaunt_tp_fused_xla``.  No CUDA library loads on
import: each kernel is built and loaded at its first launch.  As in the
reference, the name ``wkv6`` here is the wrapper, not the submodule:
reach that with ``importlib.import_module("repro_torch.kernels.wkv6")``.
"""
from .ops import (  # noqa: F401
    gaunt_tp_channel_mix,
    gaunt_tp_fused,
    gaunt_tp_fused_torch,
    mamba2_ssd,
    wkv6,
)
