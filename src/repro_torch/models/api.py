"""Public model API of the language-model path: ``build_model(cfg)`` -> a
`Model` with init / forward / prefill / decode_step / init_cache, and
`count_params`.

A copy of the reference's ``repro.models.api`` for the inference path.
Families: ssm (RWKV6, ``rwkv6-3b``) and hybrid (Zamba2, ``zamba2-2.7b``).
The model runs on CUDA unless given ``device="cpu"`` (``None`` means cuda
and raises without a GPU); there the sequence path's scan of every layer
runs on its Hopper kernel (WKV6 for RWKV6, the SSD scan for Zamba2's
Mamba-2 layers; decode runs the one-step recurrences in torch ops).
``Model.loss`` and the cross-entropy belong to the training slice (ROADMAP
Queue 1 item 12d) and are not here yet.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from ..device import resolve_device
from . import transformer as T

__all__ = ["Model", "build_model", "count_params"]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def init(self, generator: torch.Generator):
        """Random parameters from an explicit generator (on the CPU or on
        this model's device), placed on the model's device."""
        return T.init_params(generator, self.cfg, self.device)

    def forward(self, params, batch):
        """batch {"tokens": [B,S]} -> (logits [B,S,V] float32, aux)."""
        return T.forward(params, self.cfg, self._tokens(batch["tokens"]))

    def prefill(self, params, batch, max_len: int):
        """-> (last-token logits [B,1,V], cache)."""
        return T.prefill(params, self.cfg, self._tokens(batch["tokens"]), max_len)

    def decode_step(self, params, cache, tokens, pos):
        """tokens [B,1], pos [B] -> (logits [B,1,V], cache')."""
        return T.decode_step(params, self.cfg, cache, self._tokens(tokens), pos)

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
