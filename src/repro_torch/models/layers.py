"""Shared layers of the language-model path: dense, norms, embeddings.

A copy of the part of the reference's ``repro.models.layers`` that the ssm
family (RWKV6) needs.  Parameters are plain dicts of tensors under the
reference's names.  Initialisers draw from an explicit ``torch.Generator``
on the generator's own device and move the result to ``device``; with
``generator=None`` they draw from the global generator, which is how
`api.count_params` sizes a model on the ``meta`` device without allocating.
RoPE and the MLPs come with the attention families.
"""
from __future__ import annotations

import math

import torch

__all__ = ["normal", "dense_init", "dense", "norm_init", "norm_apply", "embed_init"]


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
