"""Memory-efficient attention: the forward of the reference's
``repro.models.flash.flash_attention_grouped`` (``_fwd_impl``), the online
softmax over query and key/value tiles, in plain torch ops.

Grouped-query layout throughout: q [B,Tq,KV,G,hd], k/v [B,Tk,KV,hd].  Scores
are the product in the compute dtype, then float32, scaled by 1/sqrt(hd);
the probabilities are cast back to the compute dtype for the PV product, and
the accumulator is float32.  Every (query, key) tile pair is visited, the
fully masked ones too, as in the reference.  The custom backward (the
reference's ``_bwd``) belongs to the training slice (ROADMAP Queue 1 item
12d): this forward is differentiable by autograd, at O(Tq x Tk) memory.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_grouped", "NEG_INF"]

NEG_INF = -1e30


def _tile_mask(qi, ki, qc, kc, q_offset, device):
    qpos = qi * qc + torch.arange(qc, device=device)[:, None] + q_offset
    kpos = ki * kc + torch.arange(kc, device=device)[None, :]
    return kpos <= qpos  # [qc, kc]


def flash_attention_grouped(q, k, v, causal: bool, q_chunk: int, kv_chunk: int,
                            q_offset: int = 0):
    """q [B,Tq,KV,G,hd], k/v [B,Tk,KV,hd] -> o [B,Tq,KV,G,hd] in q's dtype.
    Tq and Tk must be multiples of their tiles (the caller,
    `attention.blockwise_attention`, falls back to full attention if not)."""
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    qc, kc = min(q_chunk, Tq), min(kv_chunk, Tk)
    nq, nk = Tq // qc, Tk // kc
    scale = 1.0 / math.sqrt(hd)
    qb = q.reshape(B, nq, qc, KV, G, hd).permute(1, 0, 3, 4, 2, 5)  # [nq,B,KV,G,qc,hd]
    kb = k.reshape(B, nk, kc, KV, hd).permute(1, 0, 3, 2, 4)  # [nk,B,KV,kc,hd]
    vb = v.reshape(B, nk, kc, KV, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qblk = qb[qi]
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, qc, hd), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            s = torch.einsum("bkgqh,bksh->bkgqs", qblk, kb[ki]).float() * scale
            if causal:
                s = torch.where(_tile_mask(qi, ki, qc, kc, q_offset, q.device), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bksh->bkgqh", p.to(qblk.dtype), vb[ki]).float()
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Tq, KV, G, hd)
