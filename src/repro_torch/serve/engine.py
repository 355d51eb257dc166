"""Batched serving engines, after the reference's ``repro.serve.engine``.

`ServeEngine` — slot-based continuous batching for LM decoding over one
shared cache (attention KV, RWKV state or the Zamba2 hybrid's):

- fixed decode slots; a request is admitted into a free slot and prefilled
  token by token through the decode step (the reference's jitted scan of
  ``decode_step``), then all active slots step together;
- on CUDA the engine owns one static cache and static token and position
  buffers, and the in-place decode step (`Model.decode_step_inplace`) is
  captured once as a CUDA graph — the counterpart of the reference's
  ``jax.jit(model.decode_step)`` — at `warmup` or on the first step, then
  replayed for every decode step and every prompt token of an admission.
  The eager step stays beside it (`evaluate`, and ``eager=True`` serves
  with it): the CPU runs it, and the card holds the graph against it.  A
  capture that fails raises;
- greedy sampling is the argmax (ties to the first index, as
  ``jnp.argmax``); temperature sampling draws from a ``torch.Generator``
  seeded from (engine seed, request rid, token index), so a request's
  tokens do not depend on its batch or admission order.  JAX's threefry
  stream cannot be reproduced in torch, so sampled tokens differ from the
  reference's; greedy tokens are the same;
- per-slot stop conditions (the ``max_new_tokens`` budget, checked at
  admission too, and max_len); admission through the ported `Scheduler`.

`EquivariantServeEngine` — force-field serving: continuous batching of
energy / forces / relaxation requests over size-bucketed slot pools, after
the reference's ``EquivariantServeEngine``.

- **admission** rides `serve/scheduler.py`: a priority queue with
  per-request deadlines and structured rejection (invalid or oversized
  geometry never reaches a shared batched step);
- **slots** ride `serve/pools.py`: size-bucketed slot pools, each bucket
  with its own step for its own padded shape — on CUDA a CUDA graph
  captured once and replayed, the counterpart of the reference's per-bucket
  ``jax.jit`` — so a small molecule does not pad to the deployment's
  largest atom count;
- **stepping** is pipelined: every active bucket's step is dispatched
  (asynchronously), and the next step's admissions, host slot writes and
  device staging overlap the device's work;
- **observability** rides `serve/metrics.py`; **fault tolerance** rides
  `serve/faults.py` (injection) and the pools' recovery, and
  `serve/replicas.py` puts several engines behind one scheduler.

``warmup()`` loads the persistent autotune cache (``cfg.autotune_cache``),
seeds every bucket's measured chain keys and builds (on CUDA: captures)
every bucket's step on ghost-only slots, so the first real request pays
serving cost only; on a warm host it makes no timing run.  The force
field is an ``nn.Module`` that holds its parameters, so this constructor
takes no ``params`` (the LM engine takes them, as the reference's does).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from ..core import engine as _engine
from ..models.api import _leaves
from . import faults
from .metrics import ServeMetrics
from .pools import BucketedPools, BucketSpec
from .scheduler import REASON_INVALID, REASON_TOO_LARGE, Scheduler

__all__ = ["Request", "ServeEngine", "EquivariantRequest", "EquivariantServeEngine"]


_CAPTURE_WARMUP = 3  # eager steps on a side stream before the capture


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    rid: int = 0
    # scheduling (serve/scheduler.py): lower priority value = served first;
    # deadline = seconds of allowed queue wait from submission, None = none
    priority: int = 0
    deadline: float | None = None
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False
    reject_reason: str | None = None


def _sample_generator(seed: int, rid: int, index: int) -> torch.Generator:
    """The CPU generator of one sampled token, from (engine seed, request
    rid, token index) alone."""
    words = [x % 2**64 for x in (seed, rid, index)]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


class ServeEngine:
    """Continuous batching of LM requests over ``n_slots`` decode slots of up
    to ``max_len`` positions: `run` serves a list of `Request` through the
    `Scheduler`; `warmup` captures the decode step's graph up front (on
    CUDA; otherwise the first step does)."""

    def __init__(self, model, params, n_slots: int = 4, max_len: int = 512, seed: int = 0,
                 warmup: bool = False, eager: bool = False):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.seed = seed
        self.device = model.device
        self.cache = model.init_cache(n_slots, max_len)
        self.pos = np.full(n_slots, -1, dtype=np.int64)  # last written index
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.metrics = ServeMetrics()
        # the step's static inputs: each slot's token and its position
        self._tokens = torch.zeros((n_slots, 1), dtype=torch.long, device=self.device)
        self._positions = torch.zeros((n_slots,), dtype=torch.long, device=self.device)
        self.use_graph = self.device.type == "cuda" and not eager
        self._graph = None
        self._logits = None            # the graph's static output
        self.capture_s: float | None = None
        self.graph_bytes: int | None = None
        self.replays = 0
        if warmup:
            self.warmup()

    # ------------------------------------------------------------- the step
    def _body(self):
        """The in-place decode step on the static buffers -> logits
        [n_slots, 1, V]; the body the graph captures."""
        with torch.no_grad():
            return self.model.decode_step_inplace(self.params, self.cache, self._tokens,
                                                  self._positions)

    def warmup(self) -> None:
        """Capture the decode step's graph now (CUDA; a no-op elsewhere)."""
        if self.use_graph and self._graph is None:
            try:
                self._capture()
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture of the decode step failed: "
                                   f"{type(e).__name__}: {e}") from e

    def _capture(self) -> None:
        dev = self.device
        saved = [a.clone() for a in _leaves(self.cache)]  # the warmup steps write into it
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_CAPTURE_WARMUP):
                self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        # the cyclic collector must not run inside the capture: freeing
        # another graph there invalidates this one
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()   # as the capture does: its pool alone grows
            graph = torch.cuda.CUDAGraph()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                logits = self._body()
            torch.cuda.synchronize(dev)
            self.capture_s = time.perf_counter() - t0
            self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved
        finally:
            if collecting:
                gc.enable()
        for a, b in zip(_leaves(self.cache), saved):
            a.copy_(b)
        self._graph, self._logits = graph, logits

    def _decode(self):
        """Run the step on the staged buffers: the graph's replay, or the
        eager body -> logits [n_slots, 1, V] (the graph's static output,
        valid until its next replay)."""
        if not self.use_graph:
            return self._body()
        self.warmup()
        self._graph.replay()
        self.replays += 1
        return self._logits

    def _upload(self, tokens: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """[P, n_slots] token and position arrays -> one [2, P, n_slots] int64
        device tensor (on CUDA through pinned memory, asynchronously)."""
        a = torch.from_numpy(np.stack([tokens, pos]).astype(np.int64))
        if self.device.type != "cuda":
            return a
        return a.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, staged: torch.Tensor, j: int) -> None:
        """Step ``j`` of an upload into the static buffers."""
        with torch.no_grad():
            self._tokens.copy_(staged[0, j, :, None])
            self._positions.copy_(staged[1, j])

    def _run(self, staged: torch.Tensor, j: int):
        """Stage step ``j`` of an upload and decode."""
        self._stage(staged, j)
        return self._decode()

    def evaluate(self, tokens: np.ndarray, pos: np.ndarray):
        """The eager step on host arrays (tokens [n_slots], pos [n_slots]):
        writes into the engine's cache and returns the logits — what the
        graph is held against."""
        self._stage(self._upload(np.asarray(tokens)[None], np.asarray(pos)[None]), 0)
        return self._body()

    # ------------------------------------------------------------- admission
    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def has_active(self) -> bool:
        return any(r is not None for r in self.slot_req)

    def validate(self, req: Request):
        """Admission-time validation -> None | (reason, detail).  Token ids
        are checked against the vocabulary too: the embedding gather on the
        card has no out-of-range mode."""
        if not req.prompt:
            return (REASON_INVALID, "empty prompt")
        if req.max_new_tokens < 1:
            return (REASON_INVALID, f"max_new_tokens={req.max_new_tokens} < 1")
        if len(req.prompt) + 1 >= self.max_len:
            return (REASON_TOO_LARGE,
                    f"prompt of {len(req.prompt)} tokens leaves no decode "
                    f"room under max_len={self.max_len}")
        vocab = self.model.cfg.vocab
        if min(req.prompt) < 0 or max(req.prompt) >= vocab:
            return (REASON_INVALID, f"token id outside [0, {vocab})")
        return None

    def _reset_slot(self, slot: int) -> None:
        """Zero one slot's rows in every cache leaf (batch dim = 1)."""
        for a in _leaves(self.cache):
            a[:, slot] = 0

    def add_request(self, req: Request) -> bool:
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        n = len(req.prompt)
        with torch.no_grad():
            pre = [a.clone() for a in _leaves(self.cache)]  # fast retire restores it
            self._reset_slot(slot)  # recurrent families accumulate state otherwise
            # every prompt token through the step; inactive slots write to
            # the scratch position max_len-1, so they never clobber live rows
            tokens = np.zeros((n, self.n_slots), np.int64)
            tokens[:, slot] = req.prompt
            pos = np.full((n, self.n_slots), self.max_len - 1, np.int64)
            pos[:, slot] = np.arange(n)
            staged = self._upload(tokens, pos)
            for j in range(n):
                logits = self._run(staged, j)
            last = logits[slot, 0].clone()
        # the first generated token comes from the last prompt logits
        req.output.append(self._sample(last, req))
        with torch.no_grad():
            if len(req.output) >= req.max_new_tokens:
                # budget met at admission: the slot is never occupied, so the
                # cache goes back exactly as found
                for a, b in zip(_leaves(self.cache), pre):
                    a.copy_(b)
                req.done = True
                self.metrics.observe_complete(req)
                return True
            # keep only this slot's rows from the prefill: recurrent families
            # update every row per step, which would pollute live slots
            for a, b in zip(_leaves(self.cache), pre):
                row = a[:, slot].clone()
                a.copy_(b)
                a[:, slot] = row
        self.pos[slot] = n - 1
        self.slot_req[slot] = req
        return True

    # scheduler protocol: admission (validation runs in the scheduler)
    try_admit = add_request

    def _sample(self, logits, req: Request) -> int:
        """One token from logits [V]: the argmax (first index on ties), or a
        draw at the request's temperature from its own generator."""
        if req.temperature <= 0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.float().cpu() / req.temperature, dim=-1)
        g = _sample_generator(self.seed, req.rid, len(req.output))
        return int(torch.multinomial(probs, 1, generator=g))

    # ------------------------------------------------------------- stepping
    def step(self, overlap=None) -> None:
        """One decode step for all active slots.  ``overlap`` (the
        scheduler's admission pass) runs after the step is dispatched and
        before sampling reads the logits, so the next admissions' host work
        overlaps the device's."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        tokens = np.zeros(self.n_slots, np.int64)
        pos = np.full(self.n_slots, self.max_len - 1, np.int64)  # scratch
        for i in active:
            tokens[i] = self.slot_req[i].output[-1]
            pos[i] = self.pos[i] + 1
        logits = self._run(self._upload(tokens[None], pos[None]), 0)
        with torch.no_grad():
            # off the graph's static output before an admission replays it
            logits = logits[:, 0].clone()
            greedy = logits.argmax(dim=-1)
        if overlap is not None:
            overlap()
        greedy = greedy.cpu().numpy()
        for i in active:
            self.pos[i] += 1
            req = self.slot_req[i]
            tok = int(greedy[i]) if req.temperature <= 0 else self._sample(logits[i], req)
            req.output.append(tok)
            if len(req.output) >= req.max_new_tokens or self.pos[i] + 2 >= self.max_len:
                req.done = True
                self.metrics.observe_complete(req)
                self.slot_req[i] = None
                self.pos[i] = -1

    def run(self, requests: list[Request]) -> list[Request]:
        return Scheduler(self).run(requests)


# --------------------------------------------------------------------------
# equivariant (force-field) serving
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EquivariantRequest:
    """One molecular job: ``steps`` relaxation steps (steps=1 is a single
    energy/forces evaluation)."""

    species: np.ndarray           # [n] int
    pos: np.ndarray               # [n, 3]; on completion, the evaluated geometry
    steps: int = 1
    step_size: float = 0.0        # relaxation: pos += step_size * forces
    rid: int = 0
    # fault tolerance: failed, timed-out or non-finite steps retry this
    # request from its admission snapshot up to max_retries attempts beyond
    # the first; past it -> reject_reason='step_failed:<kind>'
    max_retries: int = 2
    # scheduling: lower priority value = served first; deadline = seconds of
    # allowed queue wait from submission, None = none
    priority: int = 0
    deadline: float | None = None
    # filled by the engine:
    energy: float | None = None
    forces: np.ndarray | None = None
    done: bool = False
    rejected: bool = False
    reject_reason: str | None = None


class EquivariantServeEngine:
    """Continuous batching for a force field (`MaceGaunt`,
    `EquiformerV2Gaunt`) over size-bucketed atom-padded slot pools: each
    step dispatches one batched evaluation per active bucket and overlaps
    the next step's admissions with the device."""

    def __init__(self, model, n_slots: int = 4, max_atoms: int = 16,
                 warmup: bool = False, buckets=None, clock=time.monotonic,
                 step_timeout_s: float | None = None,
                 retry_backoff_s: float = 5e-4, metrics=None, tag: str = ""):
        self.model = model
        self.clock = clock
        self.tag = tag                 # replica label (fault scoping)
        self.metrics = metrics if metrics is not None else ServeMetrics(clock=clock)
        specs = self._resolve_buckets(buckets, n_slots, max_atoms)
        self.pools = BucketedPools(model, specs, metrics=self.metrics, clock=clock,
                                   step_timeout_s=step_timeout_s,
                                   retry_backoff_s=retry_backoff_s, tag=tag)
        if warmup:
            self.warmup()

    def _resolve_buckets(self, buckets, n_slots, max_atoms):
        """The explicit ``buckets`` argument, else the config's
        ``serve_buckets``, else one (max_atoms, n_slots) bucket."""
        if buckets is None:
            buckets = getattr(self.model.cfg, "serve_buckets", None)
        if buckets is None:
            return (BucketSpec(max_atoms, n_slots),)
        return tuple(b if isinstance(b, BucketSpec) else BucketSpec(*b) for b in buckets)

    @property
    def max_atoms(self) -> int:
        return self.pools.max_atoms

    @property
    def n_slots(self) -> int:
        return sum(p.spec.n_slots for p in self.pools)

    @property
    def slot_req(self) -> list:
        """Flat view over every pool's slots (smallest bucket first)."""
        return [r for p in self.pools for r in p.slot_req]

    # ------------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Load the persistent autotune cache, seed every bucket's measured
        chain keys, then build every bucket's step on ghost-only slots.

        The cache (``cfg.autotune_cache``, else $REPRO_TORCH_AUTOTUNE_CACHE,
        `core/autotune_cache.py`) is loaded first: on a warm host every
        bucket's keys hit the persisted table and warmup makes zero timing
        runs.  A cache file that cannot be used (corrupt, unreadable, from
        another host; or the ``autotune_cache_load`` fault point) is counted
        in ``autotune_cache_load_failed`` and degrades to cold measurement:
        serving still comes up.

        With ``chain_tune='measure'`` each chain of the model picks its
        backend by timing the candidates at the call's row count, which
        cannot happen inside a captured graph (`engine._select_chain`
        raises there).  A bucket's step presents all its slots in one pass,
        so the model names the chain keys to measure at each bucket's
        n_slots * max_atoms atoms (``serve_chain_keys``: MACE's many-body
        chain at the storage dtypes and gate options it runs, resolving its
        'auto' storage dtype and grid gate first, once, at the largest
        bucket, and keeping them in its state (`MaceGaunt.storage_dtype`,
        `MaceGaunt.grid_gate_on`), so a model loaded from a state that holds
        them is not timed; EquiformerV2's Selfmix chain), and they are
        measured here.
        Then each bucket's step is built — on CUDA its graph is captured —
        with up to three attempts, so a transient failure (injected
        ``compile_fail`` or real) does not keep a host down."""
        cfg = self.model.cfg
        eng = _engine.get_engine()
        if cfg.autotune_cache is not None:
            eng.set_autotune_cache(cfg.autotune_cache)
        if faults._ACTIVE is not None and faults.fire(
                "autotune_cache_load", tag=self.tag) is not None:
            eng.skip_autotune_cache()
        else:
            eng._maybe_load_cache()
        if eng.cache_unusable:
            self.metrics.counters["autotune_cache_load_failed"] += 1
        for Ls, Lout, kw in self.model.serve_chain_keys(
                [p.spec.n_slots * p.spec.max_atoms for p in self.pools]):
            _engine.plan_chain(Ls, Lout, tune="measure", device=self.model.device, **kw)
        for pool in self.pools:
            for attempt in range(3):
                try:
                    pool.warmup_compile()
                    break
                except Exception:
                    self.metrics.counters["warmup_retries"] += 1
                    if attempt == 2:
                        raise

    # ------------------------------------------------------------- admission
    def has_active(self) -> bool:
        return self.pools.has_active()

    def evict_active(self) -> list:
        """Pull every in-flight request out of every pool, restored to its
        admission snapshot (replica failover requeues them on survivors)."""
        return [r for p in self.pools for r in p.evict()]

    def validate(self, req: EquivariantRequest):
        """Admission-time validation -> None | (reason, detail).  Bad
        geometry is rejected here: one NaN position in a shared batched
        step would poison every slot's gradient."""
        species = np.asarray(req.species)
        if species.size == 0:
            return (REASON_INVALID, "empty species")
        if not np.issubdtype(species.dtype, np.integer):
            return (REASON_INVALID, f"species dtype {species.dtype} is not integral")
        if species.min() < 0:
            return (REASON_INVALID, f"negative species value {int(species.min())}")
        n_species = self.model.cfg.n_species
        if species.max() >= n_species:
            # the embedding gather would index out of range
            return (REASON_INVALID,
                    f"species value {int(species.max())} >= n_species={n_species}")
        if getattr(req, "steps", 1) < 1:
            return (REASON_INVALID, f"steps={req.steps} < 1")
        pos = np.asarray(req.pos, np.float32)
        if pos.shape != (species.size, 3):
            return (REASON_INVALID, f"pos shape {pos.shape} != ({species.size}, 3)")
        if not np.all(np.isfinite(pos)):
            return (REASON_INVALID, "non-finite positions")
        if species.size > self.pools.max_atoms:
            return (REASON_TOO_LARGE,
                    f"{species.size} atoms > largest bucket {self.pools.max_atoms}")
        return None

    def try_admit(self, req: EquivariantRequest) -> bool:
        """Admit into the smallest bucket that fits, strictly: a small
        request never spills into a larger bucket, so it never makes that
        bucket build its step or pay its padding."""
        pool = self.pools.select(len(req.species))
        if pool is None:  # unreachable through the scheduler (validate)
            return False
        return pool.admit(req)

    def add_request(self, req: EquivariantRequest) -> bool:
        """Direct (scheduler-less) admission: an invalid request is consumed
        as rejected (``rejected=True, done=True``) and True is returned;
        False means no free slot right now."""
        err = self.validate(req)
        if err is not None:
            req.rejected, req.done = True, True
            req.reject_reason = f"{err[0]}:{err[1]}" if err[1] else err[0]
            self.metrics.observe_reject(req, err[0])
            return True
        return self.try_admit(req)

    # ------------------------------------------------------------- stepping
    def step(self, overlap=None) -> None:
        """One pipelined round: dispatch every active bucket's step, run the
        overlap callback (the scheduler's admission pass) and stage idle
        pools while the device computes, then wait, retire finished
        requests and advance relaxations."""
        inflight = []
        for pool in self.pools:
            h = pool.begin_step()
            if h is not None:
                inflight.append((pool, h))
        if overlap is not None:
            overlap()
        busy = {id(p) for p, _ in inflight}
        for pool in self.pools:
            # stage pools admitted into during the overlap window (their step
            # dispatches next round); in-flight pools stage again after
            # finish_step's relaxation writes
            if id(pool) not in busy and pool.n_active():
                pool.stage(early=True)
        for pool, h in inflight:
            pool.finish_step(h)

    def run(self, requests: list[EquivariantRequest]) -> list[EquivariantRequest]:
        """Serve ``requests`` to completion through a `Scheduler` (priority,
        then FIFO); each is completed or rejected in place."""
        return Scheduler(self, clock=self.clock).run(requests)
