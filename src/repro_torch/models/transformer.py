"""Model assembly of the language-model path: the ssm family (RWKV6).

A copy of the ``ssm`` branches of the reference's ``repro.models.transformer``.
Three entry points per model:

    forward(params, cfg, tokens)                 logits (+ aux, zero here)
    prefill(params, cfg, tokens, max_len)        last logits and the recurrent state
    decode_step(params, cfg, cache, tokens, pos) one token against that state

Parameters are nested dicts under the reference's names, with
``params["layers"]`` a list of per-layer dicts (the reference stacks them on
axis 0 and scans; the port loops over the list).  The cache keeps the
reference's stacked layout: ``last_x`` [L,B,d] and ``cm_last_x`` [L,B,d] in
the compute dtype, ``wkv`` [L,B,H,K,K] in float32.  The other families
raise NotImplementedError, naming the work that brings them.
"""
from __future__ import annotations

import math

import torch

from . import ssm as ssm_mod
from .layers import dense, dense_init, embed_init, norm_apply, norm_init

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache"]

_NOT_PORTED = {
    "hybrid": "ROADMAP Queue 1 item 12b (zamba2-2.7b: Mamba-2 SSD, attention, RoPE, "
              "the GeGLU MLP)",
    "dense": "ROADMAP Queue 1 item 12d (the attention families)",
    "moe": "ROADMAP Queue 1 item 12d (the attention families)",
    "vlm": "ROADMAP Queue 1 item 12d (the attention families)",
    "encdec": "ROADMAP Queue 1 item 12d (the attention families)",
}


def _check_family(cfg) -> None:
    if cfg.family != "ssm":
        where = _NOT_PORTED.get(cfg.family)
        if where is None:
            raise ValueError(f"unknown model family {cfg.family!r}")
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported "
                                  f"yet: {where}")


def _adt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(generator, cfg, device="cpu"):
    """Parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (None: the global generator, as on the ``meta`` device)."""
    _check_family(cfg)
    pd = getattr(torch, cfg.param_dtype)
    p = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, pd, device),
         "ln_f": norm_init(cfg.d_model, cfg.norm, pd, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab, dtype=pd, device=device)
    p["layers"] = [ssm_mod.rwkv6_block_init(generator, cfg, pd, device)
                   for _ in range(cfg.n_layers)]
    return p


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


def forward(p, cfg, tokens):
    """tokens [B,S] -> (logits [B,S,V] float32, aux (zero: no MoE loss))."""
    _check_family(cfg)
    h = _embed_tokens(p, cfg, tokens)
    for lp in p["layers"]:
        h = ssm_mod.rwkv6_apply(lp, h, cfg)
    return _logits(p, cfg, h), torch.zeros((), dtype=torch.float32, device=h.device)


def init_cache(cfg, batch: int, max_len: int, device="cpu"):
    """The recurrent state of every layer, zero; ``max_len`` is unused (the
    state does not grow with the sequence)."""
    _check_family(cfg)
    proto = ssm_mod.rwkv6_state_init(cfg, batch, _adt(cfg), device)
    return {name: torch.zeros((cfg.n_layers, *a.shape), dtype=a.dtype, device=device)
            for name, a in proto.items()}


def decode_step(p, cfg, cache, tokens, pos):
    """tokens [B,1], pos [B] (unused by the recurrence) -> (logits [B,1,V],
    cache')."""
    _check_family(cfg)
    h = _embed_tokens(p, cfg, tokens)
    states = []
    for i, lp in enumerate(p["layers"]):
        h, st = ssm_mod.rwkv6_decode_step(lp, h, {n: a[i] for n, a in cache.items()}, cfg)
        states.append(st)
    new_cache = {n: torch.stack([st[n] for st in states]) for n in cache}
    return _logits(p, cfg, h), new_cache


def prefill(p, cfg, tokens, max_len: int):
    """Run the sequence path: -> (last-token logits [B,1,V], populated
    cache).  The token-shift states are the last rows of each block's
    *normed* inputs."""
    _check_family(cfg)
    h = _embed_tokens(p, cfg, tokens)
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
