"""Memory-efficient attention with a FlashAttention-style backward: the
reference's ``repro.models.flash.flash_attention_grouped`` (its custom VJP,
``_fwd_impl`` and ``_bwd``) as a ``torch.autograd.Function`` in plain torch
ops (ROADMAP Queue 1 item 9).

Differentiating the tiled online softmax by autograd would save every
tile's scores and probabilities, O(Tq x Tk) memory, and undo the tiling.
The forward here keeps only ``lse = m + log(l)`` per query row beside its
output, and saves (q, k, v, o, lse); the backward recomputes each tile's
probabilities ``p = exp(s - lse)`` from them.

Grouped-query layout throughout: q [B,Tq,KV,G,hd], k/v [B,Tk,KV,hd].  Scores
are the product in the compute dtype, then float32, scaled by 1/sqrt(hd);
the probabilities are cast back to the compute dtype for the PV product, and
the accumulators are float32.  The backward works in float32 and casts dq,
dk, dv back to the inputs' dtypes.  Every (query, key) tile pair is
visited, the fully masked ones too, as in the reference.
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


def _tiles(q, k, q_chunk, kv_chunk):
    """(qc, kc, nq, nk, scale) of the tile loops."""
    hd, Tq, Tk = q.shape[-1], q.shape[1], k.shape[1]
    qc, kc = min(q_chunk, Tq), min(kv_chunk, Tk)
    return qc, kc, Tq // qc, Tk // kc, 1.0 / math.sqrt(hd)


def _q_tiles(a, nq, qc):
    """[B,Tq,KV,G,hd] -> [nq,B,KV,G,qc,hd]."""
    B, _, KV, G, hd = a.shape
    return a.reshape(B, nq, qc, KV, G, hd).permute(1, 0, 3, 4, 2, 5)


def _kv_tiles(a, nk, kc):
    """[B,Tk,KV,hd] -> [nk,B,KV,kc,hd]."""
    B, _, KV, hd = a.shape
    return a.reshape(B, nk, kc, KV, hd).permute(1, 0, 3, 2, 4)


def _scores(qblk, kblk, qi, ki, qc, kc, scale, causal, q_offset):
    s = torch.einsum("bkgqh,bksh->bkgqs", qblk, kblk).float() * scale
    if causal:
        s = torch.where(_tile_mask(qi, ki, qc, kc, q_offset, qblk.device), s, NEG_INF)
    return s


def _forward(q, k, v, causal, q_chunk, kv_chunk, q_offset):
    """-> (o [B,Tq,KV,G,hd] in q's dtype, lse [B,KV,G,Tq] float32)."""
    B, Tq, KV, G, hd = q.shape
    qc, kc, nq, nk, scale = _tiles(q, k, q_chunk, kv_chunk)
    qb, kb, vb = _q_tiles(q, nq, qc), _kv_tiles(k, nk, kc), _kv_tiles(v, nk, kc)
    outs, lses = [], []
    for qi in range(nq):
        qblk = qb[qi]
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, qc, hd), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            s = _scores(qblk, kb[ki], qi, ki, qc, kc, scale, causal, q_offset)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bksh->bkgqh", p.to(qblk.dtype), vb[ki]).float()
            m = m_new
        l_safe = l.clamp_min(1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        lses.append(m + torch.log(l_safe))
    o = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Tq, KV, G, hd)
    return o, torch.cat(lses, dim=-1)


def _backward(q, k, v, o, lse, do, causal, q_chunk, kv_chunk, q_offset):
    """The reference's ``_bwd``: the outer loop over key/value tiles, the
    inner over query tiles, float32 throughout -> (dq, dk, dv) in the
    inputs' dtypes."""
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    qc, kc, nq, nk, scale = _tiles(q, k, q_chunk, kv_chunk)
    f32 = torch.float32
    D = (do.float() * o.float()).sum(dim=-1)  # [B,Tq,KV,G]
    qb, dob = _q_tiles(q, nq, qc), _q_tiles(do, nq, qc)
    Db = D.reshape(B, nq, qc, KV, G).permute(1, 0, 3, 4, 2)  # [nq,B,KV,G,qc]
    lseb = lse.reshape(B, KV, G, nq, qc).permute(3, 0, 1, 2, 4)  # [nq,B,KV,G,qc]
    kb, vb = _kv_tiles(k, nk, kc), _kv_tiles(v, nk, kc)
    dq = torch.zeros((nq, B, KV, G, qc, hd), dtype=f32, device=q.device)
    dks, dvs = [], []
    for ki in range(nk):
        kblk, vblk = kb[ki], vb[ki]
        dk = torch.zeros((B, KV, kc, hd), dtype=f32, device=q.device)
        dv = torch.zeros_like(dk)
        for qi in range(nq):
            qblk, doblk = qb[qi], dob[qi].float()
            s = _scores(qblk, kblk, qi, ki, qc, kc, scale, causal, q_offset)
            p = torch.exp(s - lseb[qi][..., None])  # [B,KV,G,qc,kc]
            dp = torch.einsum("bkgqh,bksh->bkgqs", doblk, vblk.float())
            ds = p * (dp - Db[qi][..., None]) * scale
            dq[qi] += torch.einsum("bkgqs,bksh->bkgqh", ds, kblk.float())
            dk += torch.einsum("bkgqs,bkgqh->bksh", ds, qblk.float())
            dv += torch.einsum("bkgqs,bkgqh->bksh", p, doblk)
        dks.append(dk)
        dvs.append(dv)
    dq = dq.permute(1, 0, 4, 2, 3, 5).reshape(B, Tq, KV, G, hd)
    dk = torch.stack(dks).permute(1, 0, 3, 2, 4).reshape(B, Tk, KV, hd)
    dv = torch.stack(dvs).permute(1, 0, 3, 2, 4).reshape(B, Tk, KV, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, q_offset):
        o, lse = _forward(q, k, v, causal, q_chunk, kv_chunk, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_chunk, kv_chunk, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_grouped(q, k, v, causal: bool, q_chunk: int, kv_chunk: int,
                            q_offset: int = 0):
    """q [B,Tq,KV,G,hd], k/v [B,Tk,KV,hd] -> o [B,Tq,KV,G,hd] in q's dtype.
    Tq and Tk must be multiples of their tiles (the caller,
    `attention.blockwise_attention`, falls back to full attention if not).
    Differentiable in q, k and v through the flash backward."""
    return _FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk, q_offset)
