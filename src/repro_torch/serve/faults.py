"""Deterministic fault injection for the serve subsystem.

The port's copy of the reference's ``repro.serve.faults`` (jax-free, but
behind the reference's package ``__init__``, which imports JAX): the same
points, the same per-point seeded streams, so one seed realizes the same
schedule in both packages.

Recovery behavior must be *measured under injected faults*, not asserted —
the same discipline the repo applies to performance claims.  This module is
the injection half: a seeded `FaultPlan` names WHERE a fault fires
(injection points threaded through `SlotPool.begin_step`/`finish_step` and
`EquivariantServeEngine.warmup`) and WHEN (an explicit per-point invocation
schedule, a per-invocation probability, or both), so a chaos run is exactly
reproducible from its seed and two runs with the same plan see the same
fault sequence (`FaultPlan.fired` records it; tests compare the records).

Injection points (`POINTS`):

- ``step_raise``     — the pool's dispatched step raises (checked in
  `begin_step` before dispatch; real dispatch exceptions take the same
  recovery path);
- ``step_nonfinite`` — the step returns non-finite energy/forces for one
  slot (payload ``slots=[rel_idx,...]``), a deterministic seeded pick, or
  the whole batch (``slots='all'`` — exercises the bisect path);
- ``step_timeout``   — the step is treated as having exceeded the pool's
  watchdog deadline;
- ``compile_fail``   — a bucket's warmup compile raises (transient; the
  engine's warmup retries);
- ``autotune_cache_load`` — the persistent autotune cache is unreadable at
  warmup (`EquivariantServeEngine.warmup` counts it and falls back to cold
  measurement; serving still works).

Zero overhead when no plan is installed: call sites guard on the
module-level ``_ACTIVE is None`` check (one attribute load per step), and
nothing here ever touches device state — faults corrupt *host-side* results
or raise *host-side* exceptions, so recovery exercises the real rebuild
path (host slot arrays are the source of truth).

Scoping: a plan may carry a ``scope`` predicate over the call-site context
(pools pass ``tag``/``pool``), so chaos tests can fail exactly one replica
of a `ReplicaSet` (`serve/replicas.py` tags each replica's engine).  Only
in-scope invocations advance a point's counter — the schedule is
deterministic relative to the scoped stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import zlib
from collections import Counter

import numpy as np

__all__ = ["POINTS", "InjectedFault", "FaultSpec", "FaultPlan",
           "install", "uninstall", "active", "fire", "injected"]

POINTS = ("step_raise", "step_nonfinite", "step_timeout", "compile_fail",
          "autotune_cache_load")


class InjectedFault(RuntimeError):
    """Raised by injection points whose fault kind is 'raise'."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fired fault: the point, its invocation index, and a payload the
    call site interprets (e.g. which relative slots go non-finite)."""
    point: str
    n: int
    payload: dict = dataclasses.field(default_factory=dict)

    def key(self) -> tuple:
        """Hashable schedule identity (payload excluded — it is derived
        deterministically from (seed, point, n))."""
        return (self.point, self.n)


def _point_rng(seed: int, point: str, n: int, salt: str = ""):
    """Deterministic per-(point, invocation) generator: the decision for
    invocation ``n`` never depends on how many other points fired."""
    return np.random.default_rng(
        (int(seed), zlib.crc32((point + salt).encode()) & 0xFFFFFFFF, int(n)))


class FaultPlan:
    """A seeded, deterministic fault schedule.

    Parameters
    ----------
    seed:     base seed for every probabilistic draw.
    rates:    ``{point: probability}`` — each in-scope invocation of the
              point fires independently with this probability (seeded, so
              the schedule is a pure function of (seed, invocation index)).
    at:       ``{point: iterable[int]}`` — fire on exactly these 0-based
              in-scope invocation indices (composable with ``rates``).
    payload:  ``{point: dict}`` — static payload attached to every fire of
              the point (e.g. ``{'step_nonfinite': {'slots': [0]}}``; the
              default non-finite payload is a seeded one-slot pick).
    scope:    optional predicate over the call-site context dict; out-of-
              scope invocations neither fire nor advance the counter.
    max_fires: optional per-point cap on total fires.
    """

    def __init__(self, seed: int = 0, rates=None, at=None, payload=None,
                 scope=None, max_fires: int | None = None):
        for src in (rates, at, payload):
            for point in (src or {}):
                if point not in POINTS:
                    raise ValueError(f"unknown injection point {point!r}; "
                                     f"known: {POINTS}")
        self.seed = int(seed)
        self.rates = dict(rates or {})
        self.at = {k: frozenset(int(i) for i in v)
                   for k, v in (at or {}).items()}
        self.payload = {k: dict(v) for k, v in (payload or {}).items()}
        self.scope = scope
        self.max_fires = max_fires
        self._count: Counter = Counter()    # in-scope invocations per point
        self._fires: Counter = Counter()
        self.fired: list[FaultSpec] = []    # the realized schedule

    # ------------------------------------------------------------- schedule
    def would_fire(self, point: str, n: int) -> bool:
        """Pure query: does invocation ``n`` of ``point`` fire under this
        plan?  (Determinism proofs compare these across plan instances.)"""
        if n in self.at.get(point, ()):
            return True
        rate = self.rates.get(point, 0.0)
        return rate > 0.0 and bool(_point_rng(self.seed, point, n).random()
                                   < rate)

    def check(self, point: str, **ctx):
        """One invocation of ``point``: returns a `FaultSpec` if the plan
        fires here, else None.  Called via the module-level `fire`."""
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r}")
        if self.scope is not None and not self.scope(ctx):
            return None
        n = self._count[point]
        self._count[point] += 1
        if not self.would_fire(point, n):
            return None
        if self.max_fires is not None and self._fires[point] >= self.max_fires:
            return None
        self._fires[point] += 1
        payload = dict(self.payload.get(point, {}))
        if point == "step_nonfinite" and "slots" not in payload:
            # deterministic one-slot pick among the active slots
            n_active = max(1, int(ctx.get("n_active", 1)))
            payload["slots"] = [int(_point_rng(self.seed, point, n,
                                               salt=":pick")
                                    .integers(n_active))]
        spec = FaultSpec(point, n, payload)
        if len(self.fired) < 100_000:       # bounded record, plenty for tests
            self.fired.append(spec)
        return spec

    def schedule_keys(self) -> list[tuple]:
        """The realized schedule as comparable (point, n) keys."""
        return [s.key() for s in self.fired]


# ---------------------------------------------------------------------------
# module-level installation (call sites guard on `_ACTIVE is not None`)
# ---------------------------------------------------------------------------

_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan | None) -> FaultPlan | None:
    global _ACTIVE
    _ACTIVE = plan
    return plan


def uninstall() -> None:
    install(None)


def active() -> FaultPlan | None:
    return _ACTIVE


def fire(point: str, **ctx):
    """Check the installed plan at an injection point (None = no fault)."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.check(point, **ctx)


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Install ``plan`` for the duration of a with-block (restores the
    previously installed plan, so chaos tests nest safely)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev
