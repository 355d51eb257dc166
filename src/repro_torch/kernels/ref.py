"""Naive oracles of the port's sequence kernels, for tests."""
from __future__ import annotations

import torch

__all__ = ["wkv6_ref"]


def wkv6_ref(r, k, v, w, u):
    """Naive RWKV6 recurrence in float32, the oracle of the chunked scan.

    Shapes: r, k, w [B, T, H, K]; v [B, T, H, V]; u [H, K] -> o [B, T, H, V].
    S_t = diag(w_t) S_{t-1} + k_t v_t^T ;  o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    """
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    B, T, H, K = r.shape
    V = v.shape[-1]
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(T):
        kt, vt, rt, wt = k[:, t], v[:, t], r[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]  # [B,H,K,V]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, S + u[None, :, :, None] * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(outs, dim=1)  # [B, T, H, V]
