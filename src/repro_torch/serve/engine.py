"""Force-field serving: continuous batching of energy / forces / relaxation
requests over size-bucketed slot pools, after the reference's
``EquivariantServeEngine`` (``repro.serve.engine``).

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
serving cost only; on a warm host it makes no timing run.  The model is an
``nn.Module`` that holds its parameters, so the constructor takes no
``params``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core import engine as _engine
from . import faults
from .metrics import ServeMetrics
from .pools import BucketedPools, BucketSpec
from .scheduler import REASON_INVALID, REASON_TOO_LARGE, Scheduler

__all__ = ["EquivariantRequest", "EquivariantServeEngine"]


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
    """Continuous batching for a `MaceGaunt` over size-bucketed atom-padded
    slot pools: each step dispatches one batched evaluation per active
    bucket and overlaps the next step's admissions with the device."""

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

        With ``chain_tune='measure'`` each layer's many-body chain picks its
        backend by timing the candidates at the call's row count, which
        cannot happen inside a captured graph (`engine._select_chain`
        raises there).  A bucket's step presents n_slots * max_atoms *
        channels rows (all slots in one pass), so each bucket's key is
        measured here at that count: at float32 and at the model's storage
        dtype, gated and ungated when the grid gate is on, as the reference
        does.  The model's 'auto' storage dtype and grid gate are resolved
        first, once for the model at the largest bucket's rows, and kept in
        its state (`MaceGaunt.storage_dtype`, `MaceGaunt.grid_gate_on`): a
        model loaded from a state that holds them is not timed.  Then each
        bucket's step is built — on CUDA its graph is captured — with up to
        three attempts, so a transient failure (injected ``compile_fail`` or
        real) does not keep a host down."""
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
        # the model's 'auto' decisions are resolved before any step is
        # built: every bucket, and direct evaluation, run one function
        big = max(p.spec.n_slots * p.spec.max_atoms for p in self.pools) * cfg.channels
        dts = self.model.storage_dtype(big, self.model.device)
        gate_opts = (False, True) if self.model.grid_gate_on(big, self.model.device) else (False,)
        if cfg.chain_tune == "measure":
            for pool in self.pools:
                rows = pool.spec.n_slots * pool.spec.max_atoms * cfg.channels
                for d in dict.fromkeys(["float32", dts]):
                    for g in gate_opts:
                        _engine.plan_chain((cfg.L,) * cfg.nu, cfg.L, tune="measure",
                                           batch_hint=rows, share_hint=(0,) * cfg.nu,
                                           dtype=d, gate=g, device=self.model.device)
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
