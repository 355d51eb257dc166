"""Attention: grouped-query attention with materialized scores (short
sequences), the flash-style blockwise path (`flash.py`), and single-token
decode against a KV cache.

A copy of the reference's ``repro.models.attention``, which is plain jnp
(no Pallas kernel), so the port writes it in plain torch.  It never calls a
library attention: ``F.scaled_dot_product_attention`` rounds otherwise.
Scores are the product in the compute dtype, then float32; full and decode
attention divide by sqrt(hd), the flash path multiplies by 1/sqrt(hd), as
the reference does.  Masked scores are ``NEG_INF`` (-1e30, not -inf), so a
fully masked row stays finite.
"""
from __future__ import annotations

import math

import torch

from .flash import NEG_INF, flash_attention_grouped
from .layers import dense, dense_init

__all__ = ["NEG_INF", "attn_init", "attn_project_qkv", "attn_out", "full_attention",
           "blockwise_attention", "decode_attention"]


def attn_init(generator, d: int, n_heads: int, kv_heads: int, hd: int, bias: bool,
              dtype=torch.float32, device="cpu"):
    return {
        "wq": dense_init(generator, d, n_heads * hd, bias, dtype=dtype, device=device),
        "wk": dense_init(generator, d, kv_heads * hd, bias, dtype=dtype, device=device),
        "wv": dense_init(generator, d, kv_heads * hd, bias, dtype=dtype, device=device),
        "wo": dense_init(generator, n_heads * hd, d, dtype=dtype, device=device),
    }


def attn_project_qkv(p, x, n_heads: int, kv_heads: int, hd: int, dtype=None):
    B, T = x.shape[:2]
    q = dense(p["wq"], x, dtype).reshape(B, T, n_heads, hd)
    k = dense(p["wk"], x, dtype).reshape(B, T, kv_heads, hd)
    v = dense(p["wv"], x, dtype).reshape(B, T, kv_heads, hd)
    return q, k, v


def attn_out(p, o, dtype=None):
    B, T = o.shape[:2]
    return dense(p["wo"], o.reshape(B, T, -1), dtype)


def _group(q, kv_heads: int):
    """[B,T,H,hd] -> [B,T,KV,G,hd] for the grouped-query products."""
    B, T, H, hd = q.shape
    return q.reshape(B, T, kv_heads, H // kv_heads, hd)


def full_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """Materialized-scores attention.  q [B,Tq,H,hd], k/v [B,Tk,KV,hd]."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    s = torch.einsum("btkgh,bskh->bkgts", _group(q, KV), k).float() / math.sqrt(hd)
    if causal:
        qi = torch.arange(Tq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where((ki <= qi)[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgts,bskh->btkgh", p, v)
    return o.reshape(B, Tq, H, hd)


def blockwise_attention(q, k, v, causal: bool = True, q_chunk: int = 1024,
                        kv_chunk: int = 1024, q_offset: int = 0):
    """Flash-style attention over q_chunk x kv_chunk tiles (`flash.py`);
    falls back to `full_attention` when the tiles do not divide T."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qc, kc = min(q_chunk, Tq), min(kv_chunk, Tk)
    if Tq % qc or Tk % kc:
        return full_attention(q, k, v, causal, q_offset)
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    o = flash_attention_grouped(qg, k, v, causal, qc, kc, q_offset)
    return o.reshape(B, Tq, H, hd)


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token decode.  q [B,1,H,hd]; caches [B,S,KV,hd]; pos [B] = the
    index of the new token (the cache already holds it at pos)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = _group(q, KV)[:, 0]  # [B,KV,G,hd]
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() / math.sqrt(hd)
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None]  # [B,S]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache)
    return o.reshape(B, 1, H, hd)
