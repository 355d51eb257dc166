"""Model assembly of the language-model path: the ssm family (RWKV6) and the
hybrid family (Zamba2).

A copy of the ``ssm`` and ``hybrid`` branches of the reference's
``repro.models.transformer``.  Three entry points per model:

    forward(params, cfg, tokens)                 logits (+ aux, zero here)
    prefill(params, cfg, tokens, max_len)        last logits and the cache
    decode_step(params, cfg, cache, tokens, pos) one token against that cache

Parameters are nested dicts under the reference's names, with the
reference's stacked per-layer trees as lists of per-layer dicts
(``params["layers"]`` for ssm, ``params["mamba"]`` for hybrid; the
reference stacks them on axis 0 and scans, the port loops over the list).
Caches keep the reference's stacked layout:
- ssm: ``last_x`` [L,B,d] and ``cm_last_x`` [L,B,d] in the compute dtype,
  ``wkv`` [L,B,H,K,K] in float32;
- hybrid: ``mamba.conv`` [L,B,K-1,Ch] in the compute dtype, ``mamba.ssm``
  [L,B,H,P,N] in float32, and one KV cache per stage of the shared
  attention block, ``k`` and ``v`` [n_stages,B,max_len,KV,hd].
``decode_step`` is functional, as in the reference: it returns a new cache
and leaves the caller's as it was (the hybrid KV cache is copied once a
step and the new k and v written into the copy).  The other families raise
NotImplementedError, naming the work that brings them.
"""
from __future__ import annotations

import math

import torch

from . import ssm as ssm_mod
from .attention import (attn_init, attn_out, attn_project_qkv, blockwise_attention,
                        decode_attention, full_attention)
from .layers import (dense, dense_init, embed_init, mlp_apply, mlp_init, norm_apply,
                     norm_init, rope)

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache"]

_LATER = "ROADMAP Queue 1 item 12d (the attention families)"
_NOT_PORTED = ("dense", "moe", "vlm", "encdec")


def _check_family(cfg) -> None:
    if cfg.family in ("ssm", "hybrid"):
        return
    if cfg.family not in _NOT_PORTED:
        raise ValueError(f"unknown model family {cfg.family!r}")
    raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
                              f"{_LATER}")


def _adt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _n_stages(cfg) -> int:
    return cfg.n_layers // cfg.attn_every


def _stage_layers(p, cfg, s: int):
    """(layer index, params) of the Mamba-2 layers of stage ``s``."""
    lo = s * cfg.attn_every
    return list(enumerate(p["mamba"][lo: lo + cfg.attn_every], start=lo))


# ---------------------------------------------------------------- blocks


def _block_init(generator, cfg, device):
    """The attention block (pre-norm attention + MLP) of the hybrid family's
    shared block; no cross attention, no MoE."""
    pd = getattr(torch, cfg.param_dtype)
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, pd, device),
        "attn": attn_init(generator, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                          cfg.qkv_bias, pd, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, pd, device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, pd, device),
    }


def _apply_rope(cfg, q, k, positions):
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"M-RoPE ({cfg.name}) is not ported yet: {_LATER}")
    if cfg.partial_rotary <= 0:
        return q, k
    return (rope(q, positions, cfg.rope_theta, cfg.partial_rotary),
            rope(k, positions, cfg.rope_theta, cfg.partial_rotary))


def _attention_seq(cfg, q, k, v, causal=True):
    if q.shape[1] > cfg.attn_chunk:
        return blockwise_attention(q, k, v, causal=causal, q_chunk=cfg.attn_chunk,
                                   kv_chunk=cfg.attn_chunk)
    return full_attention(q, k, v, causal=causal)


def _block_apply(p, x, positions, cfg):
    """Full-sequence attention block -> x + attention + MLP."""
    dt = _adt(cfg)
    h = norm_apply(p["ln1"], x, cfg.norm, one_offset=cfg.rms_one_offset)
    q, k, v = attn_project_qkv(p["attn"], h, cfg.n_heads, cfg.kv_heads, cfg.hd, dt)
    q, k = _apply_rope(cfg, q, k, positions)
    x = x + attn_out(p["attn"], _attention_seq(cfg, q, k, v), dt)
    h = norm_apply(p["ln2"], x, cfg.norm, one_offset=cfg.rms_one_offset)
    return x + mlp_apply(p["mlp"], h, cfg.act, dt)


def _block_decode(p, cache, x, pos, cfg):
    """One-token attention block against its KV cache {"k", "v"}
    [B,S,KV,hd] in the compute dtype; writes the token's k and v at ``pos``
    into ``cache`` (`decode_step` hands it its own copy)."""
    if "k_scale" in cache:
        raise NotImplementedError(f"the int8 KV cache is not ported yet: {_LATER}")
    dt = _adt(cfg)
    B = x.shape[0]
    h = norm_apply(p["ln1"], x, cfg.norm, one_offset=cfg.rms_one_offset)
    q, k, v = attn_project_qkv(p["attn"], h, cfg.n_heads, cfg.kv_heads, cfg.hd, dt)
    q, k = _apply_rope(cfg, q, k, pos[:, None])
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, pos] = k[:, 0]
    cache["v"][bidx, pos] = v[:, 0]
    x = x + attn_out(p["attn"], decode_attention(q, cache["k"], cache["v"], pos), dt)
    h = norm_apply(p["ln2"], x, cfg.norm, one_offset=cfg.rms_one_offset)
    return x + mlp_apply(p["mlp"], h, cfg.act, dt)


# ---------------------------------------------------------------- params


def init_params(generator, cfg, device="cpu"):
    """Parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (None: the global generator, as on the ``meta`` device)."""
    _check_family(cfg)
    pd = getattr(torch, cfg.param_dtype)
    p = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, pd, device),
         "ln_f": norm_init(cfg.d_model, cfg.norm, pd, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab, dtype=pd, device=device)
    if cfg.family == "ssm":
        p["layers"] = [ssm_mod.rwkv6_block_init(generator, cfg, pd, device)
                       for _ in range(cfg.n_layers)]
    else:  # hybrid (zamba2)
        p["mamba"] = [{"ln": norm_init(cfg.d_model, cfg.norm, pd, device),
                       "m": ssm_mod.mamba2_init(generator, cfg, pd, device)}
                      for _ in range(cfg.n_layers)]
        p["shared"] = _block_init(generator, cfg, device)
        p["cat_proj"] = dense_init(generator, 2 * cfg.d_model, cfg.d_model, dtype=pd,
                                   device=device)
    return p


# ---------------------------------------------------------------- forward


def _embed_tokens(p, cfg, tokens):
    h = p["embed"]["embedding"][tokens].to(_adt(cfg))
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def _logits(p, cfg, h):
    h = norm_apply(p["ln_f"], h, cfg.norm, one_offset=cfg.rms_one_offset)
    if cfg.tie_embeddings:
        logits = h @ p["embed"]["embedding"].to(_adt(cfg)).T
    else:
        logits = dense(p["unembed"], h, _adt(cfg))
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits.float()


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def _cat_proj(p, cfg, x, e0):
    """The shared block's input: cat_proj of [x, the embedding output]."""
    return dense(p["cat_proj"], torch.cat([x, e0], dim=-1), _adt(cfg))


def forward(p, cfg, tokens):
    """tokens [B,S] -> (logits [B,S,V] float32, aux (zero: no MoE loss))."""
    _check_family(cfg)
    h = _embed_tokens(p, cfg, tokens)
    if cfg.family == "ssm":
        for lp in p["layers"]:
            h = ssm_mod.rwkv6_apply(lp, h, cfg)
    else:
        e0, positions = h, _positions(tokens)
        for s in range(_n_stages(cfg)):
            for _, lp in _stage_layers(p, cfg, s):
                h = h + ssm_mod.mamba2_apply(lp["m"], norm_apply(lp["ln"], h, cfg.norm), cfg)
            inp = _cat_proj(p, cfg, h, e0)
            y = _block_apply(p["shared"], inp, positions, cfg)
            h = h + y - inp  # the shared block adds its residual delta
    return _logits(p, cfg, h), torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------- caches


def _stacked_zeros(proto: dict, n: int) -> dict:
    return {name: torch.zeros((n, *a.shape), dtype=a.dtype, device=a.device)
            for name, a in proto.items()}


def init_cache(cfg, batch: int, max_len: int, device="cpu"):
    """The zero cache: ssm, every layer's recurrent state (``max_len``
    unused: the state does not grow); hybrid, every Mamba-2 layer's state
    and each stage's KV cache of ``max_len`` positions."""
    _check_family(cfg)
    dt = _adt(cfg)
    if cfg.family == "ssm":
        return _stacked_zeros(ssm_mod.rwkv6_state_init(cfg, batch, dt, device), cfg.n_layers)
    kv = (_n_stages(cfg), batch, max_len, cfg.kv_heads, cfg.hd)
    return {"mamba": _stacked_zeros(ssm_mod.mamba2_state_init(cfg, batch, dt, device),
                                    cfg.n_layers),
            "k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device)}


# ---------------------------------------------------------------- decode


def decode_step(p, cfg, cache, tokens, pos):
    """tokens [B,1], pos [B] (the new token's index; unused by the ssm
    recurrence) -> (logits [B,1,V], cache')."""
    _check_family(cfg)
    h = _embed_tokens(p, cfg, tokens)
    if cfg.family == "ssm":
        states = []
        for i, lp in enumerate(p["layers"]):
            h, st = ssm_mod.rwkv6_decode_step(lp, h, {n: a[i] for n, a in cache.items()},
                                              cfg)
            states.append(st)
        return _logits(p, cfg, h), {n: torch.stack([st[n] for st in states])
                                    for n in cache}
    e0 = h
    states = []
    kv = {n: cache[n].clone() for n in ("k", "v")}  # the caller's cache stays as it is
    for s in range(_n_stages(cfg)):
        for i, lp in _stage_layers(p, cfg, s):
            d, st = ssm_mod.mamba2_decode_step(
                lp["m"], norm_apply(lp["ln"], h, cfg.norm),
                {n: a[i] for n, a in cache["mamba"].items()}, cfg)
            h = h + d
            states.append(st)
        inp = _cat_proj(p, cfg, h, e0)
        y = _block_decode(p["shared"], {n: a[s] for n, a in kv.items()}, inp, pos, cfg)
        h = h + y - inp
    mamba = {n: torch.stack([st[n] for st in states]) for n in cache["mamba"]}
    return _logits(p, cfg, h), {"mamba": mamba, **kv}


# ---------------------------------------------------------------- prefill


def prefill(p, cfg, tokens, max_len: int):
    """Run the sequence path: -> (last-token logits [B,1,V], populated
    cache).  ssm: the token-shift states are the last rows of each block's
    *normed* inputs.  hybrid: each Mamba-2 layer's conv state is the last
    K-1 rows of its pre-activation conv input, its ssm state the scan's
    final h; each stage's k (after RoPE) and v fill the first S positions
    of its KV cache."""
    _check_family(cfg)
    h = _embed_tokens(p, cfg, tokens)
    if cfg.family == "ssm":
        states = []
        for lp in p["layers"]:
            hn = norm_apply(lp["ln1"], h, "layernorm")
            o, tm_state = ssm_mod.rwkv6_time_mix(lp["tm"], hn, cfg)
            h = h + o
            h2 = norm_apply(lp["ln2"], h, "layernorm")
            o2, _ = ssm_mod.rwkv6_channel_mix(lp["cm"], h2)
            h = h + o2
            states.append({"last_x": tm_state["last_x"], "wkv": tm_state["wkv"],
                           "cm_last_x": h2[:, -1]})
        cache = {n: torch.stack([st[n] for st in states]) for n in states[0]}
        return _logits(p, cfg, h[:, -1:]), cache
    B, S = tokens.shape
    dt = _adt(cfg)
    cache = init_cache(cfg, B, max_len, h.device)
    e0, positions = h, _positions(tokens)
    shared = p["shared"]
    for s in range(_n_stages(cfg)):
        for i, lp in _stage_layers(p, cfg, s):
            out, st = ssm_mod.mamba2_apply(lp["m"], norm_apply(lp["ln"], h, cfg.norm), cfg,
                                           return_state=True)
            h = h + out
            for n, a in st.items():
                cache["mamba"][n][i] = a
        # the shared block inline, as the reference's prefill writes it (its
        # norms take no one_offset)
        inp = _cat_proj(p, cfg, h, e0)
        hn = norm_apply(shared["ln1"], inp, cfg.norm)
        q, k, v = attn_project_qkv(shared["attn"], hn, cfg.n_heads, cfg.kv_heads, cfg.hd,
                                   dt)
        q, k = _apply_rope(cfg, q, k, positions)
        y = inp + attn_out(shared["attn"], _attention_seq(cfg, q, k, v), dt)
        y = y + mlp_apply(shared["mlp"], norm_apply(shared["ln2"], y, cfg.norm), cfg.act, dt)
        h = h + y - inp
        cache["k"][s, :, :S] = k
        cache["v"][s, :, :S] = v
    return _logits(p, cfg, h[:, -1:]), cache
