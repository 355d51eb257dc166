"""Plain-torch oracles of the port's kernels, for tests: the Gaunt
product unfused and against the exact Gaunt tensor, and the naive
sequence recurrences."""
from __future__ import annotations

import torch

from ..core.cg import gaunt_einsum_reference

__all__ = ["gaunt_fused_ref", "gaunt_oracle", "wkv6_ref", "mamba2_ssd_ref"]


def gaunt_fused_ref(x1, x2, T1, T2, P):
    """Sample-multiply-project Gaunt TP, unfused.

    x1 [B, d1], x2 [B, d2]; T1 [d1, G], T2 [d2, G] torus sample matrices;
    P [G, dout] projection.  out[B, dout] = ((x1 T1) * (x2 T2)) P.
    """
    return ((x1 @ T1) * (x2 @ T2)) @ P


def gaunt_oracle(x1, x2, L1: int, L2: int, Lout: int):
    """Ground truth: the dense einsum with the exact real Gaunt tensor."""
    return gaunt_einsum_reference(x1, x2, L1, L2, Lout)


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


def mamba2_ssd_ref(x, dt, A, B, C, D):
    """Naive Mamba-2 SSD recurrence in float32, the oracle of the chunked scan.

    x [Bt, T, H, P] (heads x headdim), dt [Bt, T, H] (after softplus),
    A [H] (negative), B, C [Bt, T, G, N] (G groups, each shared by H/G
    heads), D [H] -> y [Bt, T, H, P].
    h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t + D x_t
    """
    x, dt, A, B, C, D = (a.float() for a in (x, dt, A, B, C, D))
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hpg = H // G
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        dts = dt[:, t][..., None, None]  # [Bt,H,1,1]
        decay = torch.exp(A[None, :, None, None] * dts)
        Bg = B[:, t].repeat_interleave(hpg, dim=1)  # [Bt,H,N]
        Cg = C[:, t].repeat_interleave(hpg, dim=1)
        xt = x[:, t]  # [Bt,H,P]
        h = decay * h + dts * xt[..., :, None] * Bg[..., None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cg) + D[None, :, None] * xt)
    return torch.stack(ys, dim=1)
