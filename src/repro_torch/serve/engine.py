"""Force-field serving: continuous batching of energy / forces / relaxation
requests over one bucket of atom-padded slots.

``EquivariantServeEngine(model, n_slots, max_atoms)`` validates requests at
admission, places them into free slots, and steps all active slots together
(`serve.pools.SlotPool`).  ``warmup()`` seeds the measured many-body chain
selection at the row count a step presents (n_slots * max_atoms * channels)
and runs one ghost-only step, so the first real request pays serving cost
only.  The reference's scheduler, bucket ladder, replicas and fault
injection are not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from .pools import BucketSpec, SlotPool

__all__ = ["EquivariantRequest", "EquivariantServeEngine", "ServeMetrics"]

REASON_INVALID = "invalid"
REASON_TOO_LARGE = "too_large"


@dataclasses.dataclass
class EquivariantRequest:
    """One molecular job: ``steps`` relaxation steps (steps=1 is a single
    energy/forces evaluation)."""

    species: np.ndarray           # [n] int
    pos: np.ndarray               # [n, 3]; on completion, the evaluated geometry
    steps: int = 1
    step_size: float = 0.0        # relaxation: pos += step_size * forces
    rid: int = 0
    # filled by the engine:
    energy: float | None = None
    forces: np.ndarray | None = None
    done: bool = False
    rejected: bool = False
    reject_reason: str | None = None


class ServeMetrics:
    """Step and completion counts with step wall times (host clock)."""

    def __init__(self):
        self.counters = {"steps": 0, "completed": 0, "rejected": 0}
        self.step_s: list[float] = []

    def observe_step(self, dur_s: float) -> None:
        self.counters["steps"] += 1
        self.step_s.append(dur_s)

    def observe_complete(self) -> None:
        self.counters["completed"] += 1

    def observe_reject(self) -> None:
        self.counters["rejected"] += 1

    def summary(self) -> dict:
        s = np.asarray(self.step_s) * 1e3
        return {**self.counters,
                "step_ms_p50": float(np.median(s)) if s.size else None}


class EquivariantServeEngine:
    """Continuous batching for a `MaceGaunt` over one atom-padded slot pool."""

    def __init__(self, model, n_slots: int = 4, max_atoms: int = 16,
                 warmup: bool = False):
        self.model = model
        self.metrics = ServeMetrics()
        self.pool = SlotPool(model, BucketSpec(max_atoms, n_slots), self.metrics)
        if warmup:
            self.warmup()

    @property
    def max_atoms(self) -> int:
        return self.pool.spec.max_atoms

    @property
    def n_slots(self) -> int:
        return self.pool.spec.n_slots

    @property
    def slot_req(self) -> list:
        return list(self.pool.slot_req)

    def warmup(self) -> None:
        """Seed the measured chain selection and run one ghost-only step.

        With ``chain_tune='measure'`` each layer's many-body chain picks its
        backend by timing the candidates at the call's row count; a step
        presents n_slots * max_atoms * channels rows, so that key (gated
        when the config fuses the gate into the chain) is measured here,
        outside any served step."""
        from ..core import engine as _engine
        from ..models.equivariant import _resolve_grid_gate

        cfg = self.model.cfg
        if cfg.chain_tune == "measure":
            _engine.plan_chain((cfg.L,) * cfg.nu, cfg.L, tune="measure",
                               batch_hint=self.n_slots * self.max_atoms * cfg.channels,
                               share_hint=(0,) * cfg.nu, dtype=cfg.compute_dtype,
                               gate=_resolve_grid_gate(cfg), device=self.model.device)
        self.pool.warmup_step()

    def has_active(self) -> bool:
        return self.pool.n_active() > 0

    def validate(self, req: EquivariantRequest):
        """Admission-time validation -> None | (reason, detail).  Bad geometry
        is rejected here: one NaN position in a shared batched step would
        poison every slot's gradient."""
        species = np.asarray(req.species)
        if species.size == 0:
            return (REASON_INVALID, "empty species")
        if not np.issubdtype(species.dtype, np.integer):
            return (REASON_INVALID, f"species dtype {species.dtype} is not integral")
        if species.min() < 0 or species.max() >= self.model.cfg.n_species:
            return (REASON_INVALID, f"species outside [0, {self.model.cfg.n_species})")
        if req.steps < 1:
            return (REASON_INVALID, f"steps={req.steps} < 1")
        pos = np.asarray(req.pos, np.float32)
        if pos.shape != (species.size, 3):
            return (REASON_INVALID, f"pos shape {pos.shape} != ({species.size}, 3)")
        if not np.all(np.isfinite(pos)):
            return (REASON_INVALID, "non-finite positions")
        if species.size > self.max_atoms:
            return (REASON_TOO_LARGE,
                    f"{species.size} atoms > max_atoms {self.max_atoms}")
        return None

    def add_request(self, req: EquivariantRequest) -> bool:
        """Admit a request.  An invalid request is consumed as rejected
        (``rejected=True, done=True``) and True is returned; False means no
        free slot right now."""
        err = self.validate(req)
        if err is not None:
            req.rejected, req.done = True, True
            req.reject_reason = f"{err[0]}:{err[1]}"
            self.metrics.observe_reject()
            return True
        return self.pool.admit(req)

    def step(self) -> list:
        """Evaluate every active slot once; returns the completed requests."""
        h = self.pool.begin_step()
        return [] if h is None else self.pool.finish_step(h)

    def run(self, requests: list[EquivariantRequest]) -> list[EquivariantRequest]:
        """Serve ``requests`` to completion, admitting into slots as they
        free up (FIFO); returns them in the order given."""
        queue = deque(requests)
        while queue or self.has_active():
            while queue and self.add_request(queue[0]):
                queue.popleft()
            self.step()
        return list(requests)
