"""Shared layers of the language-model path: dense, norms, embeddings, RoPE
and the MLPs.

A copy of the reference's ``repro.models.layers``.  Parameters are plain
dicts of tensors under the reference's names.  Initialisers draw from an
explicit ``torch.Generator`` on the generator's own device and move the
result to ``device``; with ``generator=None`` they draw from the global
generator, which is how `api.count_params` sizes a model on the ``meta``
device without allocating.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["normal", "dense_init", "dense", "norm_init", "norm_apply", "embed_init",
           "rope", "rope_mrope", "mlp_init", "mlp_apply"]


def normal(generator, shape, std: float, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """N(0, std^2) samples of ``shape`` on ``device``, drawn on the
    generator's device."""
    src = generator.device if generator is not None else device
    x = torch.randn(shape, generator=generator, device=src, dtype=torch.float32)
    return x.mul_(std).to(device=device, dtype=dtype)


def dense_init(generator, d_in: int, d_out: int, bias: bool = False,
               scale: float | None = None, dtype=torch.float32, device="cpu"):
    std = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": normal(generator, (d_in, d_out), std, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x, dtype=None):
    """``x @ w`` (+ b), the weights cast to ``dtype`` at each call (float32
    parameters, compute in the activation dtype)."""
    w = p["w"] if dtype is None else p["w"].to(dtype)
    y = x @ w
    if "b" in p:
        y = y + (p["b"] if dtype is None else p["b"].to(dtype))
    return y


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32, device="cpu"):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p, x, kind: str = "rmsnorm", eps: float = 1e-6, one_offset: bool = False):
    """RMSNorm or LayerNorm computed in float32, cast back to ``x.dtype``."""
    xf = x.float()
    if kind == "rmsnorm":
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        s = p["scale"].float()
        y = y * (1.0 + s) if one_offset else y * s
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def embed_init(generator, vocab: int, d: int, dtype=torch.float32, device="cpu"):
    return {"embedding": normal(generator, (vocab, d), 0.02, dtype, device)}


def _rope_angles(positions, dim: int, theta: float):
    """positions [...] -> cos, sin [..., dim/2] (float32)."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x, positions, theta: float = 10000.0, rotary_frac: float = 1.0):
    """x [B, T, H, hd]; positions [B, T].  Half-split (GPT-NeoX style) rotary
    on the first rotary_frac * hd dims, in float32, cast back to x's dtype."""
    hd = x.shape[-1]
    rot = int(hd * rotary_frac)
    if rot == 0:
        return x
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = _rope_angles(positions, rot, theta)  # [B,T,rot/2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


def rope_mrope(x, positions3, theta: float, sections: tuple[int, ...]):
    """Qwen2-VL M-RoPE.  x [B,T,H,hd]; positions3 [B,T,3] (t, h, w ids);
    ``sections``: per-axis frequency-section sizes summing to hd/2.  Each
    frequency takes the position id of its section's axis; the map is laid
    out from ``sections`` alone (slices of positions3), so it makes no tensor
    from host data."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = positions3.float()
    pos = torch.cat([pos[..., a, None].expand(*pos.shape[:-1], n)
                     for a, n in enumerate(sections)], dim=-1)  # [B,T,half]
    ang = pos * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_init(generator, d: int, ff: int, act: str, dtype=torch.float32, device="cpu"):
    p = {"w_up": dense_init(generator, d, ff, dtype=dtype, device=device),
         "w_down": dense_init(generator, ff, d, dtype=dtype, device=device)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, d, ff, dtype=dtype, device=device)
    return p


def mlp_apply(p, x, act: str, dtype=None):
    """SwiGLU, GeGLU (tanh GELU) or a plain GELU MLP."""
    up = dense(p["w_up"], x, dtype)
    if act == "swiglu":
        h = F.silu(dense(p["w_gate"], x, dtype)) * up
    elif act == "geglu":
        h = F.gelu(dense(p["w_gate"], x, dtype), approximate="tanh") * up
    else:  # gelu_mlp
        h = F.gelu(up, approximate="tanh")
    return dense(p["w_down"], h, dtype)
