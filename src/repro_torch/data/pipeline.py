"""Deterministic, resumable, per-host-sharded synthetic LM data pipeline.

A copy of the reference's ``repro.data.pipeline`` (numpy only): the same
seed gives the same token arrays, bit for bit.

Production contract: the pipeline state is a tiny pytree (step counter +
seed + host shard) checkpointed with the model, so restart/elastic-reshard
resumes the *exact* token stream (tested).  Token streams are a stationary
Markov chain (so the LM has learnable structure; loss decreases).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LMTokenPipeline"]


@dataclasses.dataclass
class LMTokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    step: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not split over "
                             f"{self.n_hosts} hosts")
        self.local_batch = self.global_batch // self.n_hosts
        rng = np.random.default_rng(self.seed)
        # low-entropy Markov transition: each token prefers a few successors
        k = min(8, self.vocab)
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, k))
        self._probs = rng.dirichlet(np.ones(k) * 0.3, size=self.vocab)

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict, host_id: int | None = None, n_hosts: int | None = None):
        self.step = int(state["step"])
        self.seed = int(state["seed"])
        if host_id is not None:
            self.host_id, self.n_hosts = host_id, n_hosts
            self.local_batch = self.global_batch // self.n_hosts
        return self

    # -- iteration -------------------------------------------------------------
    def _gen_row(self, rng):
        toks = np.empty(self.seq_len + 1, dtype=np.int32)
        toks[0] = rng.integers(0, self.vocab)
        for t in range(self.seq_len):
            succ = self._succ[toks[t]]
            toks[t + 1] = succ[rng.choice(len(succ), p=self._probs[toks[t]])]
        return toks

    def next_batch(self) -> dict:
        """Host-local batch; deterministic in (seed, step, host shard)."""
        out = np.empty((self.local_batch, self.seq_len + 1), dtype=np.int32)
        for i in range(self.local_batch):
            row_id = self.step * self.global_batch + self.host_id * self.local_batch + i
            rng = np.random.default_rng((self.seed, row_id))
            out[i] = self._gen_row(rng)
        self.step += 1
        # Model.loss shifts internally (predict token t+1 from logits at t),
        # so labels == tokens.
        toks = out[:, :-1]
        return {"tokens": toks, "labels": toks}
