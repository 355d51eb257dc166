"""Public model API of the language-model path: ``build_model(cfg)`` -> a
`Model` with init / forward / loss / prefill / decode_step / init_cache,
`input_specs`, `count_params`, and `LMModule`, the parameter tree as an
``nn.Module`` for the train loop.

A copy of the reference's ``repro.models.api`` for all ten LM configs
(dense, moe, vlm, encdec, ssm, hybrid).  The model runs on CUDA unless given
``device="cpu"`` (``None`` means cuda and raises without a GPU); there the
sequence path's scan of every RWKV6 and Mamba-2 layer runs on its Hopper
kernel (WKV6, the SSD scan), in training too (the kernel's forward, the
plain scan's gradients); attention (with the flash backward), the MoE
dispatch, norms, RoPE, the chunked cross-entropy and the one-step
recurrences of decode are torch ops, as they are XLA code in the reference.
``Model.loss`` is the reference's: the chunked cross-entropy plus
``router_aux_loss`` times the MoE aux loss.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..config import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..distributed.sharding import gather_blocks
from . import transformer as T

__all__ = ["Model", "LMModule", "build_model", "input_specs", "count_params",
           "softmax_cross_entropy"]

_IDS = ("tokens", "labels", "positions", "positions3")


def softmax_cross_entropy(logits, labels, ignore_id: int = -1):
    """logits [B,S,V] float32, labels [B,S] -> the mean negative
    log-likelihood over the labels that are not ``ignore_id``."""
    mask = (labels != ignore_id).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def _batch(self, batch) -> dict:
        """The reference's batch dict on this model's device: token, label
        and position ids as int64, embeddings as given."""
        out = {}
        for name, a in batch.items():
            if name in _IDS:
                out[name] = self._tokens(a)
            else:  # source_embeds, embeds
                out[name] = torch.as_tensor(a, device=self.device)
        return out

    def init(self, generator: torch.Generator):
        """Random parameters from an explicit generator (on the CPU or on
        this model's device), placed on the model's device."""
        return T.init_params(generator, self.cfg, self.device)

    def forward(self, params, batch):
        """batch {"tokens": [B,S], + "positions", "positions3" (vlm),
        "source_embeds" (encdec), "embeds"} -> (logits [B,S,V] float32,
        aux: the MoE load-balancing loss, zero for the other families)."""
        return T.forward(params, self.cfg, self._batch(batch))

    def loss(self, params, batch):
        """batch as `forward`'s, plus "labels" [B,S] (labels == tokens: the
        loss shifts inside) -> (total, {"ce", "aux"}): the chunked
        next-token cross-entropy plus ``cfg.router_aux_loss`` x aux.  The
        [B,S,V] logits are never formed."""
        b = self._batch(batch)
        h, aux = T.forward(params, self.cfg, b, return_hidden=True)
        ce = T.chunked_cross_entropy(params, self.cfg, h, b["labels"])
        return ce + self.cfg.router_aux_loss * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, max_len: int):
        """-> (last-token logits [B,1,V], cache)."""
        return T.prefill(params, self.cfg, self._batch(batch), max_len)

    def decode_step(self, params, cache, tokens, pos):
        """tokens [B,1], pos [B] -> (logits [B,1,V], cache'); the caller's
        cache is left as it was."""
        return T.decode_step(params, self.cfg, cache, self._tokens(tokens), self._tokens(pos))

    def decode_step_inplace(self, params, cache, tokens, pos):
        """The decode step writing into ``cache``: tokens [B,1], pos [B]
        (int64 tensors on this model's device) -> logits [B,1,V].  The body
        the serve engine captures as a CUDA graph."""
        return T.decode_step_inplace(params, self.cfg, cache, tokens, pos)

    def init_cache(self, batch: int, max_len: int):
        return T.init_cache(self.cfg, batch, max_len, self.device)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, resolve_device(device))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for sub in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(sub)


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count without allocating (the ``meta`` device)."""
    return sum(t.numel() for t in _leaves(T.init_params(None, cfg, torch.device("meta"))))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins on the ``meta`` device (shapes and dtypes, no storage) for
    the step of ``shape.kind``, the reference's shapes with int64 ids:

    train   -> {"tokens", "labels" [B,S], (+ "positions3" [B,S,3] for vlm,
                "source_embeds" [B,S_src,d] float32 for encdec)}
    prefill -> the same without "labels"
    decode  -> {"cache": `init_cache` of B sequences of S, "tokens" [B,1],
                "pos" [B]}
    """
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def ids(*dims):
        return torch.empty(dims, dtype=torch.long, device=meta)

    if shape.kind in ("train", "prefill"):
        d = {"tokens": ids(B, S)}
        if shape.kind == "train":
            d["labels"] = ids(B, S)
        if cfg.family == "vlm":
            d["positions3"] = ids(B, S, 3)
        if cfg.family == "encdec":
            d["source_embeds"] = torch.empty((B, cfg.max_source_len, cfg.d_model),
                                             dtype=torch.float32, device=meta)
        return d
    return {"cache": T.init_cache(cfg, B, S, meta), "tokens": ids(B, 1), "pos": ids(B)}


class _Node(nn.Module):
    """One dict of the parameter tree: each key a parameter or a child."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for key, sub in tree.items():
            if isinstance(sub, torch.Tensor):
                self.register_parameter(key, nn.Parameter(sub))
            else:
                self.add_module(key, _module_of(sub))

    def tree(self) -> dict:
        return {k: _tree_of(getattr(self, k)) for k in self._keys}


def _module_of(sub):
    if isinstance(sub, dict):
        return _Node(sub)
    return nn.ModuleList([_module_of(x) for x in sub])


def _tree_of(m):
    if isinstance(m, torch.Tensor):
        return m
    if isinstance(m, nn.ModuleList):
        return [_tree_of(x) for x in m]
    return m.tree()


class LMModule(_Node):
    """A language model's parameter tree as an ``nn.Module``, for the train
    loop, `CheckpointManager` and the optimizers: each leaf a ``Parameter``
    (sharing the given tensor's storage) under its dotted tree path
    ("layers.0.attn.wq.w"), each per-layer list a ``ModuleList``.
    ``tree()`` gives back the nested dicts and lists of those very
    parameters, the tree `Model` takes; ``loss(batch)`` is `Model.loss` on
    it.  The sharded train loop turns the parameters into `DTensor`s; the
    loss then reads each layer's weights gathered whole as that layer
    computes (`distributed.sharding.gather_blocks`)."""

    gathers_blocks = True  # the sharded step leaves the gathering to `loss`

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.model = Model(cfg, next(_leaves(params)).device)

    def loss(self, batch):
        return self.model.loss(gather_blocks(self.tree()), batch)
