"""Public wrappers of the port's kernels.  The Gaunt wrappers are thin calls
that resolve a plan on the engine (`repro_torch.core.engine`) pinned to the
fused backends, as the reference's ``repro.kernels.ops`` does; `wkv6` is the
RWKV6 scan and `mamba2_ssd` the Mamba-2 SSD scan, each on its Hopper kernel.

``device`` is the plan's device: None means cuda, and raises without a GPU
(pass ``device="cpu"`` to run the plain versions on the CPU).
"""
from __future__ import annotations

from ..core import engine as _engine
from .mamba2 import mamba2_ssd_hopper
from .wkv6 import wkv6_hopper

__all__ = ["gaunt_tp_fused", "gaunt_tp_fused_torch", "gaunt_tp_channel_mix", "wkv6",
           "mamba2_ssd"]


def gaunt_tp_fused(x1, x2, L1: int, L2: int, Lout: int | None = None, *, device=None,
                   dtype="float32"):
    """Fused sample-multiply-project Gaunt tensor product on the Hopper pair
    kernel (``fused_hopper``; no gradient).  x1 [..., (L1+1)^2],
    x2 [..., (L2+1)^2] -> [..., (Lout+1)^2], Lout defaulting to L1 + L2.
    ``dtype`` is the plan's storage dtype: 'float32' (the reference's
    wrapper) or 'bfloat16' (the kernel's bf16 mode; the output is bf16)."""
    p = _engine.plan(L1, L2, Lout, kind="pairwise", backend="fused_hopper",
                     requires_grad=False, device=device, dtype=dtype)
    return p.apply(x1, x2)


def gaunt_tp_fused_torch(x1, x2, L1: int, L2: int, Lout: int | None = None, *,
                         device=None):
    """The same product in plain torch ops (``fused_torch``, differentiable;
    the reference's ``gaunt_tp_fused_xla``)."""
    p = _engine.plan(L1, L2, Lout, kind="pairwise", backend="fused_torch",
                     device=device)
    return p.apply(x1, x2)


def gaunt_tp_channel_mix(x1, x2, w_mix, L1: int, L2: int, Lout: int | None = None, *,
                         device=None):
    """Channel-mixing Gaunt TP (paper §3.3, the O(C^2) variant):

        y_e = sum_{c1,c2} w[c1,c2,e] (x1_{c1} (x)_Gaunt x2_{c2})

    In the sample domain the product is pointwise, so the channel mix
    commutes with the basis change and is one contraction over sample
    values.  x1 [..., C1, d1], x2 [..., C2, d2], w_mix [C1, C2, E] ->
    [..., E, dout].
    """
    p = _engine.plan(L1, L2, Lout, kind="channel_mix", backend="fused_torch",
                     device=device)
    return p.apply(x1, x2, w_mix)


def wkv6(r, k, v, w, u, chunk: int = 64):
    """RWKV6 linear attention with data-dependent decay: the chunked scan on
    the Hopper kernel for CUDA tensors, its plain version for CPU tensors
    (no gradient on the kernel route)."""
    return wkv6_hopper(r, k, v, w, u, chunk=chunk)


def mamba2_ssd(x, dt, A, B, C, D, chunk: int = 64):
    """Mamba-2 SSD: the chunked scan on the Hopper kernel for CUDA tensors,
    its plain version for CPU tensors (no gradient on the kernel route).
    x [Bt,T,H,P], dt [Bt,T,H], A [H], B, C [Bt,T,G,N], D [H] -> y [Bt,T,H,P]
    float32."""
    return mamba2_ssd_hopper(x, dt, A, B, C, D, chunk=chunk)
