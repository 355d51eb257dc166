"""Public model API of the language-model path: ``build_model(cfg)`` -> a
`Model` with init / forward / prefill / decode_step / init_cache, and
`count_params`.

A copy of the reference's ``repro.models.api`` for the inference path, for
all ten LM configs (dense, moe, vlm, encdec, ssm, hybrid).  The model runs
on CUDA unless given ``device="cpu"`` (``None`` means cuda and raises
without a GPU); there the sequence path's scan of every RWKV6 and Mamba-2
layer runs on its Hopper kernel (WKV6, the SSD scan); attention, the MoE
dispatch, norms, RoPE and the one-step recurrences of decode are torch ops,
as they are XLA code in the reference.  ``Model.loss`` and the
cross-entropy belong to the training slice (ROADMAP Queue 1 item 9) and are
not here yet.
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

    def _batch(self, batch) -> dict:
        """The reference's batch dict on this model's device: token and
        position ids as int64, embeddings as given."""
        out = {}
        for name, a in batch.items():
            if name in ("tokens", "positions", "positions3"):
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
