"""Per-precision tolerance tiers, the reference's (``repro.testing.precision``).

The tiers come from the storage quantization, not the accumulation: sums
run at >= f32, so a stage's error is bounded by rounding its inputs and
outputs to storage — bf16 has an 8-bit mantissa (eps = 2^-8 ~ 3.9e-3), and
the Gaunt pipeline rounds at ~3 storage boundaries (operand entry, a stage's
store, the SH exit).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tol_for", "assert_close"]

# relative tolerance per storage dtype x strictness tier:
#   'identity'  — same math, two execution routes (backend-vs-oracle checks)
#   'transform' — a full equivariance transport (rotate -> product -> compare)
#   'loose'     — long chains / gradient checks (more storage round trips)
_TOLS = {
    "float32": {"identity": 3e-4, "transform": 5e-4, "loose": 2e-3},
    "bfloat16": {"identity": 5e-2, "transform": 7e-2, "loose": 1.2e-1},
    "float64": {"identity": 1e-10, "transform": 1e-9, "loose": 1e-8},
}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def tol_for(dtype, tier: str = "identity") -> float:
    """The relative tolerance for ``dtype`` ('float32' | 'bfloat16' |
    'float64', a numpy or a torch dtype) at the strictness ``tier``."""
    name = _dtype_name(dtype)
    try:
        return _TOLS[name][tier]
    except KeyError:
        raise ValueError(f"no tolerance tier {tier!r} for dtype {name!r}") from None


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a).astype(np.float64)


def assert_close(got, ref, dtype=None, tier: str = "identity", tol=None):
    """Scale-relative closeness: max|got - ref| <= tol * max(1, max|ref|).

    ``got`` and ``ref`` are tensors (any device, any dtype) or arrays.
    ``dtype=None`` takes the tier's dtype from ``got``'s own dtype."""
    if tol is None:
        tol = tol_for(got.dtype if dtype is None else dtype, tier)
    got, ref = _f64(got), _f64(ref)
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol:.1e} * scale {scale:.3e}"
