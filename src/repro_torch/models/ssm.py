"""State-space blocks: Mamba-2 (SSD), the mixer of the hybrid family
(Zamba2), and RWKV6 (Finch) time mix and channel mix, the block of the ssm
family.

A copy of the reference's ``repro.models.ssm``, as plain functions over
parameter dicts under the reference's names.  Each block has a sequence
path (the chunked scans' training routes
`kernels.mamba2.mamba2_ssd_hopper_grad` and `kernels.wkv6.wkv6_hopper_grad`:
the Hopper kernel's forward on CUDA tensors, with the plain chunked scan's
gradients in the backward, so a model trains on the card through the
kernels; under ``torch.no_grad()`` one kernel launch) and a single-step
decode path carrying an explicit recurrent state, O(1) per token, in torch
ops.  The casts to the activation dtype sit where the reference puts them,
so the bfloat16 path rounds at the same places.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba2 import mamba2_ssd_hopper_grad
from ..kernels.wkv6 import wkv6_hopper_grad
from .layers import dense, dense_init, norm_apply, norm_init, normal

__all__ = ["mamba2_init", "mamba2_scan_inputs", "mamba2_apply", "mamba2_state_init",
           "mamba2_decode_step", "rwkv6_init", "rwkv6_projections", "rwkv6_time_mix",
           "rwkv6_channel_mix", "rwkv6_state_init", "rwkv6_apply", "rwkv6_decode_step",
           "rwkv6_block_init"]


# ---------------------------------------------------------------- Mamba-2


def _m2_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    return d_in, H, cfg.ssm_state, cfg.ssm_groups


def mamba2_init(generator, cfg, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    d_in, H, N, G = _m2_dims(cfg)
    conv_ch = d_in + 2 * G * N
    f32 = torch.float32
    return {
        "in_proj": dense_init(generator, d, 2 * d_in + 2 * G * N + H, dtype=dtype,
                              device=device),
        "conv_w": normal(generator, (cfg.ssm_conv, conv_ch), 0.2, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 8.0, H, dtype=f32, device=device)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "out_norm": norm_init(d_in, "rmsnorm", dtype, device),
        "out_proj": dense_init(generator, d_in, d, dtype=dtype, device=device),
    }


def _split_in_proj(y, cfg):
    """in_proj's output -> z, x, B, C, dt (views)."""
    d_in, H, N, G = _m2_dims(cfg)
    return torch.split(y, [d_in, d_in, G * N, G * N, H], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x [B,T,Ch], w [K,Ch] -> [B,T,Ch]: the sum of K
    shifted taps in x's dtype, in the reference's order."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(K))
    return out + b


def mamba2_scan_inputs(p, x, cfg):
    """The mixer up to the scan.  x [B,T,d] (normed) -> (z [B,T,d_in],
    conv_in [B,T,Ch] (the pre-activation conv input, whose last K-1 rows
    are the decode state), and the scan's inputs x [B,T,H,P], dt [B,T,H]
    (float32, after softplus), A [H], B, C [B,T,G,N], D [H])."""
    d_in, H, N, G = _m2_dims(cfg)
    dt_c = getattr(torch, cfg.dtype)
    Bt, T, _ = x.shape
    z, xc, Bm, Cm, dt = _split_in_proj(dense(p["in_proj"], x, dt_c), cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(dt_c), p["conv_b"].to(dt_c)))
    xc, Bm, Cm = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B,T,H]
    A = -torch.exp(p["A_log"])  # [H] < 0
    scan = (xc.reshape(Bt, T, H, cfg.ssm_headdim), dt, A, Bm.reshape(Bt, T, G, N),
            Cm.reshape(Bt, T, G, N), p["D"])
    return z, conv_in, scan


def mamba2_apply(p, x, cfg, return_state: bool = False):
    """x [B,T,d] (normed) -> [B,T,d] (sequence path).  With return_state,
    also the decode state {"conv": the last K-1 pre-activation conv inputs,
    "ssm": the final h [B,H,P,N] float32}, as the reference's prefill
    takes them."""
    d_in = _m2_dims(cfg)[0]
    dt_c = getattr(torch, cfg.dtype)
    Bt, T, _ = x.shape
    z, conv_in, scan = mamba2_scan_inputs(p, x, cfg)
    ych, h = mamba2_ssd_hopper_grad(*scan, chunk=min(64, T), return_state=True)
    yc = ych.reshape(Bt, T, d_in).to(x.dtype)
    yc = norm_apply(p["out_norm"], yc * F.silu(z), "rmsnorm")
    out = dense(p["out_proj"], yc, dt_c)
    if not return_state:
        return out
    return out, {"conv": conv_in[:, T - (cfg.ssm_conv - 1):], "ssm": h}


def mamba2_state_init(cfg, batch: int, dtype=torch.float32, device="cpu"):
    d_in, H, N, G = _m2_dims(cfg)
    conv_ch = d_in + 2 * G * N
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, cfg.ssm_headdim, N), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode_step(p, x, state, cfg):
    """x [B,1,d] (normed) -> ([B,1,d], new state).  O(1) per token.  The
    reference mixes float32 (dt, h, D) with the compute dtype (x, B, C) and
    lets jnp promote to float32; torch's einsum takes one dtype, so C is
    cast explicitly."""
    d_in, H, N, G = _m2_dims(cfg)
    dt_c = getattr(torch, cfg.dtype)
    Bt = x.shape[0]
    z, xc, Bm, Cm, dt = _split_in_proj(dense(p["in_proj"], x[:, 0], dt_c), cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)  # [B,Ch]
    buf = torch.cat([state["conv"], conv_in[:, None]], dim=1)  # [B,K,Ch]
    # the K taps as one float32-accumulated dot, rounded once (as the
    # reference's einsum)
    taps = (buf.float() * p["conv_w"].to(dt_c).float()[None]).sum(dim=1).to(dt_c)
    conv_out = F.silu(taps + p["conv_b"].to(dt_c))
    xc, Bm, Cm = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B,H]
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(Bt, H, cfg.ssm_headdim)
    Bg = Bm.reshape(Bt, G, N).repeat_interleave(H // G, dim=1)
    Cg = Cm.reshape(Bt, G, N).repeat_interleave(H // G, dim=1)
    decay = torch.exp(A[None, :, None, None] * dt[..., None, None])
    h = decay * state["ssm"] + dt[..., None, None] * xh[..., None] * Bg[:, :, None, :]
    yh = torch.einsum("bhpn,bhn->bhp", h, Cg.float()) + p["D"][None, :, None] * xh
    yc = yh.reshape(Bt, d_in).to(x.dtype)
    yc = norm_apply(p["out_norm"], yc * F.silu(z), "rmsnorm")
    out = dense(p["out_proj"], yc, dt_c)[:, None]
    return out, {"conv": buf[:, 1:], "ssm": h}


# ---------------------------------------------------------------- RWKV6

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
        o, S = wkv6_hopper_grad(r, k, v, w, p["u"], chunk=min(64, T), return_state=True)
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
