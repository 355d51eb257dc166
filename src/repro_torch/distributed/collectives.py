"""int8 error-feedback compression of the cross-pod gradient reduction, the
port of the reference's ``repro.distributed.collectives``.

Gradients already reduced over 'data' are quantized to int8 with one
absmax/127 scale a tensor, summed over the 'pod' axis's process group,
divided by the pod count, and the quantization residual is carried as
error-feedback state, so the compression is unbiased over time.  The
'data' reduction stays full precision: the pod axis is the long hop, where
compression pays.

As in the reference (a ``psum`` of the dequantized values), the sum over
the pods is taken of each pod's ``q * scale`` in float32: the numbers are
the int8 scheme's, the bytes on the wire are float32.
"""
from __future__ import annotations

import torch

__all__ = ["int8_ef_cross_pod_mean", "ef_state_init"]


def ef_state_init(grads: dict) -> dict:
    """Zero error-feedback state, float32, one leaf a gradient (a `DTensor`
    on the same placements for a `DTensor` gradient)."""
    return {k: torch.zeros_like(g, dtype=torch.float32) for k, g in grads.items()}


def _quant(x: torch.Tensor, amax: torch.Tensor | None = None):
    """int8 codes of ``x`` and their scale, absmax/127 (``amax`` when given:
    the whole tensor's, for a shard)."""
    amax = x.abs().max() if amax is None else amax
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_ef_cross_pod_mean(grads: dict, ef: dict, mesh):
    """Mean-reduce ``grads`` over the 'pod' mesh axis with int8 and error
    feedback -> (reduced grads, new ef).  ``grads`` and ``ef`` are dicts of
    plain tensors (this rank's values) or of `DTensor`s (this pod's values
    on placements replicated over 'pod', as the sharded train step holds
    them: each rank quantizes its shard with the scale of the whole tensor,
    the absmax taken over the mesh dims that shard it).  The identity,
    ``ef`` unchanged, when the mesh has no 'pod' axis."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    names = list(mesh.mesh_dim_names or ())
    if "pod" not in names:
        return grads, ef
    group = mesh.get_group("pod")
    npod = mesh.size(names.index("pod"))
    out, new_ef = {}, {}
    for k, g in grads.items():
        sharded = isinstance(g, DTensor)
        pl = tuple(g.placements) if sharded else ()
        if sharded and pl[names.index("pod")].is_shard():
            raise ValueError(f"{k}: a gradient sharded over 'pod' has no pod-local whole")
        e = ef[k].to_local() if isinstance(ef[k], DTensor) else ef[k]
        x = (g.to_local() if sharded else g).to(torch.float32) + e
        amax = x.abs().max()
        for i, p in enumerate(pl):
            if p.is_shard():
                dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
        q, scale = _quant(x, amax)
        deq = q.to(torch.float32) * scale
        resid = x - deq
        dist.all_reduce(deq, group=group)
        mean = deq / npod
        if sharded:
            mean, resid = (DTensor.from_local(t, mesh, pl, run_check=False, shape=g.shape,
                                              stride=g.stride()) for t in (mean, resid))
        out[k], new_ef[k] = mean, resid
    return out, new_ef
