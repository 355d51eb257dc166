"""RWKV6 (Finch) time mix and channel mix: the state-space block of the ssm
family.

A copy of the RWKV6 half of the reference's ``repro.models.ssm``, as plain
functions over parameter dicts under the reference's names.  Each block has
a sequence path (the chunked WKV scan, `kernels.wkv6.wkv6_hopper`: the
Hopper kernel on CUDA tensors) and a single-step decode path carrying an
explicit recurrent state, O(1) per token.  The casts to the activation
dtype sit where the reference puts them, so the bfloat16 path rounds at the
same places.  The Mamba-2 half comes with the hybrid family.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.wkv6 import wkv6_hopper
from .layers import dense, dense_init, norm_apply, norm_init, normal

__all__ = ["rwkv6_init", "rwkv6_projections", "rwkv6_time_mix", "rwkv6_channel_mix",
           "rwkv6_state_init", "rwkv6_apply", "rwkv6_decode_step", "rwkv6_block_init"]

_LORA = 32


def _r6_dims(cfg):
    K = cfg.rwkv_head_k
    H = cfg.d_model // K
    return H, K


def rwkv6_init(generator, cfg, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    H, K = _r6_dims(cfg)
    f32 = torch.float32

    def nrm(shape, std):
        return normal(generator, shape, std, f32, device)

    def lin():
        return dense_init(generator, d, d, dtype=dtype, device=device)

    # the draws follow the reference's order of keys (it splits one key
    # per leaf; torch draws from one stream, so only the shapes match)
    return {
        # time-mix
        "mu": torch.full((5, d), 0.5, dtype=f32, device=device),  # r,k,v,w,g static mix
        "maa_w1": nrm((d, 5 * _LORA), 0.01),
        "maa_w2": nrm((5, _LORA, d), 0.01),
        "wr": lin(),
        "wk": lin(),
        "wv": lin(),
        "wg": lin(),
        "wo": lin(),
        "decay_base": torch.full((d,), -2.0, dtype=f32, device=device),
        "decay_w1": nrm((d, _LORA * 2), 0.01),
        "decay_w2": nrm((_LORA * 2, d), 0.01),
        "u": nrm((H, K), 0.3),
        "ln_x": norm_init(d, "layernorm", f32, device),  # per-head groupnorm
    }


def _shift(x):
    """x [B,T,d] -> the previous step of each position, zero at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _rwkv_mix(p, x, sx):
    """Data-dependent token-shift mixing (maa).  x, sx [B,T,d] ->
    [xw, xk, xv, xr, xg] in x's dtype."""
    xxx = x + sx * p["mu"][0]  # the mu_r slot mixes the lora input
    lat = torch.tanh(xxx.float() @ p["maa_w1"])  # [B,T,5*lora]
    B, T = x.shape[:2]
    lat = lat.reshape(B * T, 5, -1).transpose(0, 1)  # [5,BT,lora]
    deltas = torch.bmm(lat, p["maa_w2"]).reshape(5, B, T, -1)  # [5,B,T,d]
    return [(x + sx * (p["mu"][i] + deltas[i]).to(x.dtype)).to(x.dtype) for i in range(5)]


def _rwkv_groupnorm(p, x, H):
    """Per-head groupnorm over K within each head.  x [B,T,d]."""
    B, T, d = x.shape
    xh = x.reshape(B, T, H, d // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xf = ((xh - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, d)
    return (xf * p["ln_x"]["scale"] + p["ln_x"]["bias"]).to(x.dtype)


def rwkv6_projections(p, x, cfg, xprev):
    """The time mix's inputs to the WKV scan: (r, k, v, w, g) from x and its
    shifted copy.  r, k, v [B,T,H,K] and g [B,T,d] in the compute dtype;
    the decay w [B,T,H,K] in float32, in (0, 1)."""
    H, K = _r6_dims(cfg)
    B, T, d = x.shape
    dt_c = getattr(torch, cfg.dtype)
    xw, xk, xv, xr, xg = _rwkv_mix(p, x, xprev - x)
    r = dense(p["wr"], xr, dt_c).reshape(B, T, H, K)
    k = dense(p["wk"], xk, dt_c).reshape(B, T, H, K)
    v = dense(p["wv"], xv, dt_c).reshape(B, T, H, K)
    g = F.silu(dense(p["wg"], xg, dt_c))
    dw = torch.tanh(xw.float() @ p["decay_w1"]) @ p["decay_w2"]
    w = torch.exp(-torch.exp(p["decay_base"] + dw)).reshape(B, T, H, K)
    return r, k, v, w, g


def rwkv6_time_mix(p, x, cfg, state=None):
    """Sequence path if state is None, else single-step (T == 1).

    Returns (out, {"last_x", "wkv"}): the last row of x (the block's normed
    input) and the WKV state S [B,H,K,V] in float32."""
    H, K = _r6_dims(cfg)
    B, T, d = x.shape
    dt_c = getattr(torch, cfg.dtype)
    xprev = _shift(x) if state is None else state["last_x"][:, None]
    r, k, v, w, g = rwkv6_projections(p, x, cfg, xprev)
    if state is None:
        o, S = wkv6_hopper(r, k, v, w, p["u"], chunk=min(64, T), return_state=True)
    else:
        S = state["wkv"]  # [B,H,K,V]
        kt, vt, rt, wt = k[:, 0], v[:, 0], r[:, 0], w[:, 0]
        kv = kt[..., :, None] * vt[..., None, :]  # in the compute dtype
        o = torch.einsum("bhk,bhkv->bhv", rt.float(),
                         S + p["u"][None, :, :, None] * kv)[:, None]
        S = wt[..., :, None] * S + kv
    o = o.reshape(B, T, d).to(x.dtype)
    out = dense(p["wo"], _rwkv_groupnorm(p, o, H) * g, dt_c)
    return out, {"last_x": x[:, -1], "wkv": S}


def rwkv6_channel_mix(p, x, state=None):
    """Sequence path if state is None, else single-step against the previous
    step's input ``state`` [B,d].  Returns (out, x[:, -1] on the decode path
    else None)."""
    dt_c = x.dtype
    xprev = _shift(x) if state is None else state[:, None]
    sx = xprev - x
    xk = (x + sx * p["cm_mu"][0]).to(dt_c)
    xr = (x + sx * p["cm_mu"][1]).to(dt_c)
    kk = torch.square(torch.relu(dense(p["cm_k"], xk, dt_c)))
    kv = dense(p["cm_v"], kk, dt_c)
    out = torch.sigmoid(dense(p["cm_r"], xr, dt_c)) * kv
    return out, (x[:, -1] if state is not None else None)


def rwkv6_state_init(cfg, batch: int, dtype=torch.float32, device="cpu"):
    H, K = _r6_dims(cfg)
    return {
        "last_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, K, K), dtype=torch.float32, device=device),
        "cm_last_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }


def rwkv6_apply(p, x, cfg):
    """One block on the sequence path (no state out)."""
    o, _ = rwkv6_time_mix(p["tm"], norm_apply(p["ln1"], x, "layernorm"), cfg)
    x = x + o
    o, _ = rwkv6_channel_mix(p["cm"], norm_apply(p["ln2"], x, "layernorm"))
    return x + o


def rwkv6_decode_step(p, x, state, cfg):
    """One block, one token: x [B,1,d] -> (x', state').  The token-shift
    states hold the *normed* block inputs, as the sequence path stores
    them."""
    h = norm_apply(p["ln1"], x, "layernorm")
    o, tm_state = rwkv6_time_mix(p["tm"], h, cfg,
                                 state={"last_x": state["last_x"], "wkv": state["wkv"]})
    x = x + o
    h2 = norm_apply(p["ln2"], x, "layernorm")
    o2, cm_last = rwkv6_channel_mix(p["cm"], h2, state=state["cm_last_x"])
    return x + o2, {"last_x": tm_state["last_x"], "wkv": tm_state["wkv"],
                    "cm_last_x": cm_last}


def rwkv6_block_init(generator, cfg, dtype=torch.float32, device="cpu"):
    f32 = torch.float32
    return {
        "ln1": norm_init(cfg.d_model, "layernorm", f32, device),
        "ln2": norm_init(cfg.d_model, "layernorm", f32, device),
        "tm": rwkv6_init(generator, cfg, dtype, device),
        "cm": _rwkv_cm_init(generator, cfg, dtype, device),
    }


def _rwkv_cm_init(generator, cfg, dtype, device):
    return {
        "cm_mu": torch.full((2, cfg.d_model), 0.5, dtype=torch.float32, device=device),
        "cm_k": dense_init(generator, cfg.d_model, cfg.d_ff, dtype=dtype, device=device),
        "cm_v": dense_init(generator, cfg.d_ff, cfg.d_model, dtype=dtype, device=device),
        "cm_r": dense_init(generator, cfg.d_model, cfg.d_model, dtype=dtype, device=device),
    }
