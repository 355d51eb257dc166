"""Model assembly of every language-model family, after the reference's
``repro.models.transformer``.  Five entry points per model:

    forward(params, cfg, batch[, return_hidden])      logits (or the hidden
                                                      states) and the MoE aux loss
    chunked_cross_entropy(params, cfg, h, labels)     next-token CE, 256 tokens
                                                      of logits at a time
    prefill(params, cfg, batch, max_len)              last logits and the cache
    decode_step(params, cfg, cache, tokens, pos)      one token against that cache
    decode_step_inplace(params, cfg, cache, tokens, pos)
                                                      the same, writing into ``cache``

Families: dense | moe | vlm (M-RoPE) | ssm (RWKV6) | hybrid (Zamba2) |
encdec (Whisper, stub frontend).  ``batch`` is the reference's dict:
``tokens`` [B,S], and optionally ``positions`` [B,S], ``positions3``
[B,S,3] (vlm), ``source_embeds`` [B,S_src,d] (encdec) and ``embeds``
[B,S,d] (a stub frontend's embeddings in place of the token embedding).

Parameters are nested dicts under the reference's names, with the
reference's stacked per-layer trees as lists of per-layer dicts
(``layers``; ``enc_layers`` for encdec; ``mamba`` for hybrid — the
reference stacks them on axis 0 and scans, the port loops over the list;
MoE experts stay stacked on their own axis inside each layer).  Caches keep
the reference's stacked layout:
- attention families: ``k``, ``v`` [L,B,max_len,KV,hd] in the compute
  dtype, or int8 with ``k_scale``, ``v_scale`` [L,B,max_len,KV] float16
  (``kv_cache_dtype='int8'``: absmax per position and head); encdec also
  ``xk``, ``xv`` [L,B,S_src,KV,hd], the cross-attention keys and values
  that prefill writes and decode reads;
- ssm: ``last_x`` [L,B,d] and ``cm_last_x`` [L,B,d] in the compute dtype,
  ``wkv`` [L,B,H,K,K] in float32;
- hybrid: ``mamba.conv`` [L,B,K-1,Ch] in the compute dtype, ``mamba.ssm``
  [L,B,H,P,N] in float32, and one KV cache per stage of the shared
  attention block, ``k`` and ``v`` [n_stages,B,max_len,KV,hd].

With ``cfg.remat`` each block of the sequence path (and each Mamba-2 step of
the hybrid family) runs under activation checkpointing
(``torch.utils.checkpoint``, non-reentrant) when grad mode is on, where the
reference wraps its scan bodies in ``jax.checkpoint``: the backward
recomputes the block from its input instead of keeping its activations.
It changes no number.

``decode_step_inplace`` writes the new token's k and v, and every layer's
new recurrent state, into the cache it is given and returns the logits: it
makes no tensor from host data and reads nothing back, so the serve engine
captures it as a CUDA graph over a static cache.  ``decode_step`` is
functional, as in the reference: it copies the cache, runs the in-place
step on the copy and leaves the caller's cache as it was.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import GatheredBlock, constrain_batch
from . import ssm as ssm_mod
from .attention import (attn_init, attn_out, attn_project_qkv, blockwise_attention,
                        decode_attention, full_attention)
from .layers import (dense, dense_init, embed_init, mlp_apply, mlp_init, norm_apply,
                     norm_init, normal, rope, rope_mrope)
from .moe import moe_apply, moe_init

__all__ = ["init_params", "forward", "chunked_cross_entropy", "prefill", "decode_step",
           "decode_step_inplace", "init_cache", "clone_cache"]

_ATTENTION = ("dense", "moe", "vlm", "encdec")
_FAMILIES = _ATTENTION + ("ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")


def _adt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _n_stages(cfg) -> int:
    return cfg.n_layers // cfg.attn_every


def _stage_layers(p, cfg, s: int):
    """(layer index, params) of the Mamba-2 layers of stage ``s``."""
    lo = s * cfg.attn_every
    return list(enumerate(p["mamba"][lo: lo + cfg.attn_every], start=lo))


# ---------------------------------------------------------------- blocks


def _block_init(generator, cfg, device, cross: bool = False):
    """Pre-norm attention block: attention (+ cross attention) and an MLP or
    a mixture of experts."""
    pd = getattr(torch, cfg.param_dtype)
    p = {
        "ln1": norm_init(cfg.d_model, cfg.norm, pd, device),
        "attn": attn_init(generator, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                          cfg.qkv_bias, pd, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, pd, device),
    }
    if cross:
        p["ln_x"] = norm_init(cfg.d_model, cfg.norm, pd, device)
        p["xattn"] = attn_init(generator, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                               False, pd, device)
    if cfg.family == "moe":
        p["moe"] = moe_init(generator, cfg.d_model, cfg.n_experts,
                            cfg.d_ff_expert or cfg.d_ff, cfg.n_shared_experts, cfg.act, pd,
                            device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, pd, device)
    return p


def _apply_rope(cfg, q, k, positions):
    if cfg.mrope_sections is not None:
        if positions.ndim == 2:  # text only: t = h = w
            positions = torch.stack([positions] * 3, dim=-1)
        return (rope_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                rope_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    if cfg.partial_rotary <= 0:
        return q, k
    return (rope(q, positions, cfg.rope_theta, cfg.partial_rotary),
            rope(k, positions, cfg.rope_theta, cfg.partial_rotary))


def _attention_seq(cfg, q, k, v, causal=True):
    if q.shape[1] > cfg.attn_chunk:
        return blockwise_attention(q, k, v, causal=causal, q_chunk=cfg.attn_chunk,
                                   kv_chunk=cfg.attn_chunk)
    return full_attention(q, k, v, causal=causal)


def _ffn(p, h, cfg, dt):
    """The block's MLP or mixture of experts -> (y, aux loss)."""
    if cfg.family == "moe":
        return moe_apply(p["moe"], h, cfg.n_experts, cfg.top_k, cfg.capacity_factor,
                         cfg.act, dt)
    return mlp_apply(p["mlp"], h, cfg.act, dt), torch.zeros((), device=h.device)


def _cross_kv(p, cfg, enc, dt):
    """The cross attention's keys and values over the encoder output."""
    B = enc.shape[0]
    kx = dense(p["xattn"]["wk"], enc, dt).reshape(B, -1, cfg.kv_heads, cfg.hd)
    vx = dense(p["xattn"]["wv"], enc, dt).reshape(B, -1, cfg.kv_heads, cfg.hd)
    return kx, vx


def _cross(p, cfg, x, kx, vx, dt, decode: bool = False):
    """x + the cross attention of x over the encoder's keys and values."""
    h = norm_apply(p["ln_x"], x, cfg.norm)
    qx = dense(p["xattn"]["wq"], h, dt).reshape(*h.shape[:2], cfg.n_heads, cfg.hd)
    if decode:  # one token; every source position is visible
        last = torch.full((x.shape[0],), kx.shape[1] - 1, device=x.device)
        ox = decode_attention(qx, kx, vx, last)
    else:
        ox = _attention_seq(cfg, qx, kx, vx, causal=False)
    return x + attn_out(p["xattn"], ox, dt)


def _block_apply(p, x, positions, cfg, causal=True, enc=None):
    """Full-sequence block -> (x, aux)."""
    dt = _adt(cfg)
    h = norm_apply(p["ln1"], x, cfg.norm, one_offset=cfg.rms_one_offset)
    q, k, v = attn_project_qkv(p["attn"], h, cfg.n_heads, cfg.kv_heads, cfg.hd, dt)
    q, k = _apply_rope(cfg, q, k, positions)
    x = x + attn_out(p["attn"], _attention_seq(cfg, q, k, v, causal=causal), dt)
    if enc is not None:  # cross attention (enc-dec)
        x = _cross(p, cfg, x, *_cross_kv(p, cfg, enc, dt), dt)
    h = norm_apply(p["ln2"], x, cfg.norm, one_offset=cfg.rms_one_offset)
    y, aux = _ffn(p, h, cfg, dt)
    return x + y, aux


def _quant_kv(x):
    """[..., hd] -> int8 values and the float16 absmax scale of each row
    (rounded half to even, as ``jnp.round``)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _block_decode(p, cache, x, pos, cfg, enc_kv=None):
    """One-token block against its KV cache {"k", "v"[, "k_scale",
    "v_scale"]} ([B,S,KV,hd] views of the stacked cache): writes the token's
    k and v at ``pos`` into ``cache`` and returns the block's output."""
    dt = _adt(cfg)
    B = x.shape[0]
    h = norm_apply(p["ln1"], x, cfg.norm, one_offset=cfg.rms_one_offset)
    q, k, v = attn_project_qkv(p["attn"], h, cfg.n_heads, cfg.kv_heads, cfg.hd, dt)
    q, k = _apply_rope(cfg, q, k, pos[:, None])
    bidx = torch.arange(B, device=x.device)
    if "k_scale" in cache:  # int8 cache: quantize the new row, read dequantized
        for n, a in (("k", k), ("v", v)):
            qa, sa = _quant_kv(a[:, 0])
            cache[n][bidx, pos] = qa
            cache[n + "_scale"][bidx, pos] = sa
        kc, vc = (cache[n].to(dt) * cache[n + "_scale"].to(dt)[..., None] for n in ("k", "v"))
    else:
        cache["k"][bidx, pos] = k[:, 0]
        cache["v"][bidx, pos] = v[:, 0]
        kc, vc = cache["k"], cache["v"]
    x = x + attn_out(p["attn"], decode_attention(q, kc, vc, pos), dt)
    if enc_kv is not None:
        x = _cross(p, cfg, x, *enc_kv, dt, decode=True)
    h = norm_apply(p["ln2"], x, cfg.norm, one_offset=cfg.rms_one_offset)
    return x + _ffn(p, h, cfg, dt)[0]


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
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        p["layers"] = [_block_init(generator, cfg, device) for _ in range(cfg.n_layers)]
    elif fam == "ssm":
        p["layers"] = [ssm_mod.rwkv6_block_init(generator, cfg, pd, device)
                       for _ in range(cfg.n_layers)]
    elif fam == "hybrid":  # zamba2
        p["mamba"] = [{"ln": norm_init(cfg.d_model, cfg.norm, pd, device),
                       "m": ssm_mod.mamba2_init(generator, cfg, pd, device)}
                      for _ in range(cfg.n_layers)]
        p["shared"] = _block_init(generator, cfg, device)
        p["cat_proj"] = dense_init(generator, 2 * cfg.d_model, cfg.d_model, dtype=pd,
                                   device=device)
    else:  # encdec
        p["enc_layers"] = [_block_init(generator, cfg, device)
                           for _ in range(cfg.n_enc_layers)]
        p["layers"] = [_block_init(generator, cfg, device, cross=True)
                       for _ in range(cfg.n_layers)]
        p["enc_ln_f"] = norm_init(cfg.d_model, cfg.norm, pd, device)
        p["dec_pos"] = normal(generator, (cfg.max_seq, cfg.d_model), 0.01, pd, device)
    return p


# ---------------------------------------------------------------- forward


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (to nearest, ties to even), on the host
    with no tensor, so that a captured step makes none."""
    if dtype == torch.float64:
        return x
    if dtype == torch.float16:
        return float(np.float16(x))
    bits = int(np.array(x, np.float32).view(np.uint32))
    if dtype == torch.bfloat16:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(np.array(bits, np.uint32).view(np.float32))


def _embed_tokens(p, cfg, tokens):
    """The embedding rows in the compute dtype, times sqrt(d) where the
    config scales them.  The factor is first rounded to the compute dtype,
    as the reference's weakly typed Python scalar is (45.25, not 45.2548,
    for gemma-2b at bf16), so that the scaled rows round as the
    reference's do."""
    h = p["embed"]["embedding"][tokens].to(_adt(cfg))
    if cfg.embed_scale:
        h = h * _in_dtype(math.sqrt(cfg.d_model), h.dtype)
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


def _positions(batch, tokens):
    """The batch's ``positions``, else 0..S-1 for every row."""
    if "positions" in batch:
        return batch["positions"]
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def _cat_proj(p, cfg, x, e0):
    """The shared block's input: cat_proj of [x, the embedding output]."""
    return dense(p["cat_proj"], torch.cat([x, e0], dim=-1), _adt(cfg))


def _sinusoid_pos(T: int, d: int, dtype, device):
    """Whisper's sinusoidal encoder positions [T, d], computed in float64 on
    the host as the reference does, then cast."""
    ang = np.arange(T)[:, None] / (10000 ** (2 * np.arange(d // 2)[None, :] / d))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


def _encode(p, cfg, source_embeds):
    """The Whisper encoder over precomputed frame embeddings (the conv
    frontend is a stub): non-causal blocks, then its final norm."""
    h = source_embeds.to(_adt(cfg))
    B, T = h.shape[:2]
    h = h + _sinusoid_pos(T, cfg.d_model, h.dtype, h.device)[None]
    pos = torch.arange(T, device=h.device)[None].expand(B, T)
    for lp in p["enc_layers"]:
        h, _ = _remat(cfg, _block_apply, lp, h, pos, cfg, False)
    return norm_apply(p["enc_ln_f"], h, cfg.norm)


def _remat(cfg, fn, *args):
    """fn(*args), under activation checkpointing when ``cfg.remat`` and
    grad mode is on (the reference's ``jax.checkpoint`` of a scan body).
    The blocks draw no random numbers, so no RNG state is kept.  A block
    whose weights are gathered when read (``args[0]`` a `GatheredBlock`:
    the sharded train step) is always checkpointed, so its whole weights
    live only while it computes, in the forward and again in the backward."""
    if (cfg.remat or isinstance(args[0], GatheredBlock)) and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _mamba_step(lp, h, cfg):
    """One Mamba-2 layer of the hybrid family with its residual."""
    return h + ssm_mod.mamba2_apply(lp["m"], norm_apply(lp["ln"], h, cfg.norm), cfg)


def forward(p, cfg, batch, return_hidden: bool = False):
    """batch (tokens [B,S], + the family's extras) -> (logits [B,S,V]
    float32, aux: the sum over layers of the MoE load-balancing loss, zero
    for the other families).  With ``return_hidden``, the hidden states
    [B,S,d] before the output head in place of the logits (the chunked
    cross-entropy's input: the [B,S,V] logits are never formed)."""
    _check_family(cfg)
    fam = cfg.family
    tokens = batch["tokens"]
    S = tokens.shape[1]
    h = batch["embeds"].to(_adt(cfg)) if "embeds" in batch else _embed_tokens(p, cfg, tokens)
    positions = _positions(batch, tokens)
    if fam == "vlm" and "positions3" in batch:
        positions = batch["positions3"]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if fam in ("dense", "moe", "vlm"):
        for lp in p["layers"]:
            h, a = _remat(cfg, _block_apply, lp, h, positions, cfg)
            # the reference's pin of the carried state to the batch axes at
            # the block boundary (a no-op here, `distributed.sharding`)
            h = constrain_batch(h)
            aux = aux + a
    elif fam == "ssm":
        for lp in p["layers"]:
            h = _remat(cfg, ssm_mod.rwkv6_apply, lp, h, cfg)
    elif fam == "hybrid":
        e0 = h
        for s in range(_n_stages(cfg)):
            for _, lp in _stage_layers(p, cfg, s):
                h = _remat(cfg, _mamba_step, lp, h, cfg)
            inp = _cat_proj(p, cfg, h, e0)
            y, a = _block_apply(p["shared"], inp, positions, cfg)
            h = h + y - inp  # the shared block adds its residual delta
            aux = aux + a
    else:  # encdec
        enc = _encode(p, cfg, batch["source_embeds"])
        h = h + p["dec_pos"][:S].to(h.dtype)[None]
        for lp in p["layers"]:
            h, a = _remat(cfg, _block_apply, lp, h, positions, cfg, True, enc)
            aux = aux + a
    if return_hidden:
        return h, aux
    return _logits(p, cfg, h), aux


def _ce_slice(p, cfg, h, labels, ignore_id: int):
    """(summed NLL, count) of one slice: h [B,C,d], labels [B,C]."""
    logits = _logits(p, cfg, h)  # [B,C,V] float32
    mask = (labels != ignore_id).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return ((lse - ll) * mask).sum(), mask.sum()


def chunked_cross_entropy(p, cfg, h, labels, chunk: int = 256, ignore_id: int = -1):
    """Next-token cross-entropy (the logits at t predict labels at t + 1),
    the mean over labels that are not ``ignore_id``, without forming the
    [B,S,V] logits: the sequence is cut into ``chunk``-token slices (padded
    to whole slices with ``ignore_id``), and each slice's logits are
    recomputed in the backward (``torch.utils.checkpoint``), so forward and
    backward hold B x chunk x V of them at a time."""
    hs, ys = h[:, :-1], labels[:, 1:]
    S = hs.shape[1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        hs = F.pad(hs, (0, 0, 0, pad))
        ys = F.pad(ys, (0, pad), value=ignore_id)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S + pad, C):
        args = (p, cfg, hs[:, c:c + C], ys[:, c:c + C], ignore_id)
        if torch.is_grad_enabled():
            a, n = checkpoint(_ce_slice, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            a, n = _ce_slice(*args)
        nll, cnt = nll + a, cnt + n
    return nll / cnt.clamp_min(1.0)


# ---------------------------------------------------------------- caches


def _stacked_zeros(proto: dict, n: int) -> dict:
    return {name: torch.zeros((n, *a.shape), dtype=a.dtype, device=a.device)
            for name, a in proto.items()}


def init_cache(cfg, batch: int, max_len: int, device="cpu"):
    """The zero cache of ``batch`` sequences of up to ``max_len`` positions
    (ssm: every layer's recurrent state, ``max_len`` unused)."""
    _check_family(cfg)
    dt = _adt(cfg)
    fam = cfg.family
    if fam in _ATTENTION:
        kv = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
        if cfg.kv_cache_dtype == "int8":
            c = {"k": torch.zeros(kv, dtype=torch.int8, device=device),
                 "v": torch.zeros(kv, dtype=torch.int8, device=device),
                 "k_scale": torch.zeros(kv[:-1], dtype=torch.float16, device=device),
                 "v_scale": torch.zeros(kv[:-1], dtype=torch.float16, device=device)}
        else:
            c = {"k": torch.zeros(kv, dtype=dt, device=device),
                 "v": torch.zeros(kv, dtype=dt, device=device)}
        if fam == "encdec":
            xkv = (cfg.n_layers, batch, cfg.max_source_len, cfg.kv_heads, cfg.hd)
            c["xk"] = torch.zeros(xkv, dtype=dt, device=device)
            c["xv"] = torch.zeros(xkv, dtype=dt, device=device)
        return c
    if fam == "ssm":
        return _stacked_zeros(ssm_mod.rwkv6_state_init(cfg, batch, dt, device), cfg.n_layers)
    kv = (_n_stages(cfg), batch, max_len, cfg.kv_heads, cfg.hd)
    return {"mamba": _stacked_zeros(ssm_mod.mamba2_state_init(cfg, batch, dt, device),
                                    cfg.n_layers),
            "k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device)}


def clone_cache(cache):
    """A copy of a cache (nested dicts of tensors)."""
    if isinstance(cache, dict):
        return {n: clone_cache(a) for n, a in cache.items()}
    return cache.clone()


# ---------------------------------------------------------------- decode


def decode_step_inplace(p, cfg, cache, tokens, pos):
    """tokens [B,1], pos [B] (the new token's index; unused by the ssm
    recurrence) -> logits [B,1,V]; the token's k and v and every layer's new
    state are written into ``cache``."""
    _check_family(cfg)
    fam = cfg.family
    h = _embed_tokens(p, cfg, tokens)
    if fam in _ATTENTION:
        self_keys = [n for n in cache if not n.startswith("x")]
        if fam == "encdec":
            h = h + p["dec_pos"][pos][:, None].to(h.dtype)
        for i, lp in enumerate(p["layers"]):
            enc_kv = (cache["xk"][i], cache["xv"][i]) if fam == "encdec" else None
            h = _block_decode(lp, {n: cache[n][i] for n in self_keys}, h, pos, cfg, enc_kv)
    elif fam == "ssm":
        for i, lp in enumerate(p["layers"]):
            h, st = ssm_mod.rwkv6_decode_step(lp, h, {n: a[i] for n, a in cache.items()},
                                              cfg)
            for n, a in st.items():
                cache[n][i].copy_(a)
    else:  # hybrid
        e0 = h
        mamba = cache["mamba"]
        for s in range(_n_stages(cfg)):
            for i, lp in _stage_layers(p, cfg, s):
                d, st = ssm_mod.mamba2_decode_step(
                    lp["m"], norm_apply(lp["ln"], h, cfg.norm),
                    {n: a[i] for n, a in mamba.items()}, cfg)
                h = h + d
                for n, a in st.items():
                    mamba[n][i].copy_(a)
            inp = _cat_proj(p, cfg, h, e0)
            y = _block_decode(p["shared"], {n: cache[n][s] for n in ("k", "v")}, inp, pos,
                              cfg)
            h = h + y - inp
    return _logits(p, cfg, h)


def decode_step(p, cfg, cache, tokens, pos):
    """tokens [B,1], pos [B] -> (logits [B,1,V], cache'): the in-place step
    on a copy, so the caller's cache stays as it was."""
    new = clone_cache(cache)
    return decode_step_inplace(p, cfg, new, tokens, pos), new


# ---------------------------------------------------------------- prefill


def _write_kv(cache, i: int, S: int, k, v) -> None:
    """Layer ``i``'s k and v [B,S,KV,hd] into its first S cache positions
    (quantized on an int8 cache)."""
    if "k_scale" in cache:
        for n, a in (("k", k), ("v", v)):
            cache[n][i, :, :S], cache[n + "_scale"][i, :, :S] = _quant_kv(a)
    else:
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v


def prefill(p, cfg, batch, max_len: int):
    """Run the sequence path -> (last-token logits [B,1,V], populated
    cache).  Attention families: each layer's k (after RoPE) and v fill the
    first S positions, encdec the cross keys and values over the whole
    source.  ssm: the token-shift states are the last rows of each block's
    *normed* inputs.  hybrid: each Mamba-2 layer's conv state is the last
    K-1 rows of its pre-activation conv input, its ssm state the scan's
    final h; each stage's k and v fill its KV cache."""
    _check_family(cfg)
    fam = cfg.family
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed_tokens(p, cfg, tokens)
    positions = _positions(batch, tokens)
    dt = _adt(cfg)
    if fam == "ssm":
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
    cache = init_cache(cfg, B, max_len, h.device)
    if fam in _ATTENTION:
        enc = None
        if fam == "encdec":
            enc = _encode(p, cfg, batch["source_embeds"])
            h = h + p["dec_pos"][:S].to(h.dtype)[None]
            xkv = []
        for i, lp in enumerate(p["layers"]):
            hn = norm_apply(lp["ln1"], h, cfg.norm, one_offset=cfg.rms_one_offset)
            q, k, v = attn_project_qkv(lp["attn"], hn, cfg.n_heads, cfg.kv_heads, cfg.hd, dt)
            q, k = _apply_rope(cfg, q, k, positions)
            h = h + attn_out(lp["attn"], _attention_seq(cfg, q, k, v, causal=True), dt)
            _write_kv(cache, i, S, k, v)
            if enc is not None:
                kx, vx = _cross_kv(lp, cfg, enc, dt)
                h = _cross(lp, cfg, h, kx, vx, dt)
                xkv.append((kx, vx))
            hn = norm_apply(lp["ln2"], h, cfg.norm, one_offset=cfg.rms_one_offset)
            h = h + _ffn(lp, hn, cfg, dt)[0]
        if enc is not None:  # the source's own length, as the reference stacks them
            cache["xk"] = torch.stack([kx for kx, _ in xkv])
            cache["xv"] = torch.stack([vx for _, vx in xkv])
        return _logits(p, cfg, h[:, -1:]), cache
    e0 = h
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
