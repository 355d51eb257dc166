"""Mixture-of-Experts: top-k router and sort-based capacity dispatch, after
the reference's ``repro.models.moe``.

Routing, sorting and capacity are per batch row (GShard-style groups).  Per
row: flatten the (token, choice) pairs, sort them by expert (stable), rank
each within its expert from the segment starts, drop the ranks past the
static capacity C = ceil(T k / E * cf) (rounded up to 8) into the drop bin
E*C, gather the kept entries into [E, C, d] expert batches, run every
expert as one batched einsum, and scatter the gate-weighted outputs back
through the inverse of the sort.  Undropped tokens get exactly the dense
mixture (`moe_dense_reference`).  Shared experts (Qwen-MoE) are a gated
dense branch.

Every shape is static and nothing is read back to the host (no boolean
index, ``nonzero`` or ``item``), so the decode step that runs this can be
captured as a CUDA graph.  The reference's layout hints
(``constrain_batch`` on the dispatch activations, ``constrain_ep_weights``
on the expert weights) sit where it puts them; in the port they change no
layout and no number (`distributed.sharding`: a rank already holds its own
batch rows, and its step gathers whole weights before computing).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain_batch, constrain_ep_weights
from .layers import dense, dense_init, normal

__all__ = ["moe_capacity", "moe_init", "moe_apply", "moe_dense_reference"]


def moe_capacity(T: int, E: int, k: int, cf: float) -> int:
    c = int(math.ceil(T * k / E * cf))
    return max(8, ((c + 7) // 8) * 8)


def moe_init(generator, d: int, E: int, ff: int, n_shared: int, act: str,
             dtype=torch.float32, device="cpu"):
    std = 1.0 / math.sqrt(d)
    p = {
        "router": dense_init(generator, d, E, dtype=torch.float32, device=device),
        "we_gate": normal(generator, (E, d, ff), std, dtype, device),
        "we_up": normal(generator, (E, d, ff), std, dtype, device),
        "we_down": normal(generator, (E, ff, d), 1.0 / math.sqrt(ff), dtype, device),
    }
    if n_shared:
        p["shared"] = {
            "w_gate": dense_init(generator, d, ff * n_shared, dtype=dtype, device=device),
            "w_up": dense_init(generator, d, ff * n_shared, dtype=dtype, device=device),
            "w_down": dense_init(generator, ff * n_shared, d, dtype=dtype, device=device),
            "w_shared_gate": dense_init(generator, d, 1, dtype=dtype, device=device),
        }
    return p


def _act(g, act: str):
    return F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")


def _route(p, x2d, k: int):
    """Router over rows [..., d] -> (probs, renormalised top-k gates, ids)."""
    probs = torch.softmax(x2d.float() @ p["router"]["w"], dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def _shared(p, x, dtype=None):
    sp = p["shared"]
    hs = F.silu(dense(sp["w_gate"], x, dtype)) * dense(sp["w_up"], x, dtype)
    return dense(sp["w_down"], hs, dtype) * torch.sigmoid(dense(sp["w_shared_gate"], x, dtype))


def _rows(a, idx):
    """a [B, M, d] gathered at idx [B, N] along axis 1 -> [B, N, d]."""
    return torch.gather(a, 1, idx[..., None].expand(*idx.shape, a.shape[-1]))


def moe_apply(p, x, E: int, k: int, cf: float, act: str = "swiglu", dtype=None):
    """x [B, T, d] -> (y [B, T, d], aux loss scalar).  Per-row dispatch."""
    B, T, d = x.shape
    C = moe_capacity(T, E, k, cf)
    N = T * k
    dev = x.device
    probs, gate_vals, gate_idx = _route(p, x, k)  # [B,T,E], [B,T,k], [B,T,k]

    # load-balancing aux (Switch): E * sum_e f_e P_e, averaged over rows
    experts = torch.arange(E, device=dev)
    ce = (gate_idx[..., None] == experts).float().sum(2).mean(1)  # [B,E]
    pe = probs.mean(1)
    aux = (E * (ce / k * pe).sum(-1)).mean()

    flat_e = gate_idx.reshape(B, N)
    flat_g = gate_vals.reshape(B, N)
    entries = torch.arange(N, device=dev).expand(B, N)
    flat_tok = torch.div(entries, k, rounding_mode="floor")  # token of each entry
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    inv_order = torch.empty_like(order).scatter_(1, order, entries)  # entry -> sorted pos
    sg = torch.gather(flat_g, 1, order)
    stok = torch.gather(flat_tok, 1, order)
    # segment starts per expert by comparison in sorted order (no bincount)
    starts = (se[:, :, None] < experts).sum(1)  # [B,E]
    rank = entries - torch.gather(starts, 1, se)
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)  # E*C = the drop bin
    # the slot -> sorted-entry inverse map; every dropped entry writes N
    # into the drop bin, and N points at the zero row appended below
    entry_of_slot = torch.full((B, E * C + 1), N, dtype=torch.long, device=dev).scatter_(
        1, slot, torch.where(keep, entries, N))
    xg = constrain_batch(_rows(x, stok))  # [B,N,d] in sorted order
    xg_pad = torch.cat([xg, x.new_zeros(B, 1, d)], dim=1)
    xe = constrain_batch(_rows(xg_pad, entry_of_slot[:, : E * C]).reshape(B, E, C, d),
                         "model")
    wg, wu, wd = (constrain_ep_weights(p[n] if dtype is None else p[n].to(dtype))
                  for n in ("we_gate", "we_up", "we_down"))
    g = constrain_batch(torch.einsum("becd,edf->becf", xe, wg), "model")
    u = constrain_batch(torch.einsum("becd,edf->becf", xe, wu), "model")
    out = constrain_batch(torch.einsum("becf,efd->becd", _act(g, act) * u, wd),
                          "model").reshape(B, E * C, d)
    out = torch.cat([out, out.new_zeros(B, 1, d)], dim=1)

    out_ent = _rows(out, slot)  # [B,N,d] sorted
    contrib = out_ent * torch.where(keep, sg, 0.0)[..., None].to(out.dtype)
    # back to (token, choice) order, then the sum over choices
    contrib = constrain_batch(_rows(contrib, inv_order))
    y = constrain_batch(contrib.reshape(B, T, k, d).sum(dim=2))
    if "shared" in p:
        y = y + _shared(p, x, dtype)
    return y.to(x.dtype), aux


def moe_dense_reference(p, x, E: int, k: int, act: str = "swiglu"):
    """O(E) dense mixture, no dropping: the oracle of the tests."""
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    _, gate_vals, gate_idx = _route(p, xt, k)
    gates = torch.zeros((xt.shape[0], E), dtype=gate_vals.dtype,
                        device=x.device).scatter_(1, gate_idx, gate_vals)
    g = torch.einsum("td,edf->tef", xt, p["we_gate"])
    u = torch.einsum("td,edf->tef", xt, p["we_up"])
    out = torch.einsum("tef,efd->ted", _act(g, act) * u, p["we_down"])
    y = torch.einsum("te,ted->td", gates.to(out.dtype), out)
    if "shared" in p:
        y = y + _shared(p, xt)
    return y.reshape(B, T, d)
