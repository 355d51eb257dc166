"""Replica failover for serving, after the reference's
``repro.serve.replicas``.

A `ReplicaSet` runs N serve engines behind ONE Scheduler-compatible facade
(`validate`/`try_admit`/`has_active`/`step`), so the admission queue,
deadline handling, and metrics above it are exactly the single-engine
stack.  Health-checking reuses `distributed/fault_tolerance.py`: every
replica writes a `Heartbeat` file after each clean step (the cluster
health-checker idiom — staleness is judged by re-READING the file, so an
external prober sees the same signal), and a per-replica `StragglerMonitor`
tracks its step durations.

Failure handling:

- a replica whose pools keep failing (``max_fail_streak`` consecutive
  stepped rounds with new failures and no clean progress) or whose
  heartbeat file has gone stale (``stale_after_s``) is **cordoned**: its
  in-flight requests are pulled out restored to their admission snapshots
  (`SlotPool.evict`) and re-submitted to the survivors through
  `AdmissionQueue.requeue` — the ORIGINAL ``_seq`` is preserved, so
  failover costs a request none of its (priority, FIFO) standing;
- a cordoned replica is **restarted** after an exponential backoff (a
  supervisor's restart: same engine object — its host slot
  arrays and its buckets' captured CUDA graphs survive — fresh health
  state, forced heartbeat);
- while ANY replica is cordoned the set reports ``has_active() == True``,
  so the scheduler's drain keeps pumping (and keeps reaching the restart
  check) instead of mis-rejecting queued work against a temporarily
  shrunken fleet.

The factory receives ``(idx, metrics)`` and must tag its engine
``tag=f"replica{idx}"`` if fault plans are to target one replica by scope
(`serve/faults.py`); the shared `ServeMetrics` sink keeps the aggregate
picture while per-replica failure attribution reads each engine's own pool
counters (`SlotPool.failures`), which a shared sink cannot split.
"""
from __future__ import annotations

import json
import tempfile
import time

from ..distributed.fault_tolerance import Heartbeat, StragglerMonitor
from .metrics import ServeMetrics
from .scheduler import Scheduler

__all__ = ["ReplicaSet"]


class _Replica:
    """One engine plus its health state (internal to `ReplicaSet`)."""

    def __init__(self, idx: int, engine, heartbeat_path: str):
        self.idx = idx
        self.name = f"replica{idx}"
        self.engine = engine
        self.heartbeat = Heartbeat(heartbeat_path, interval_s=0.0)
        self.straggler = StragglerMonitor()
        self.live = True
        self.fail_streak = 0       # stepped rounds with failures, no progress
        self.restarts = 0
        self.restart_at = 0.0      # injectable-clock time of next restart try
        self.steps = 0             # rounds this replica was stepped
        self._last_failures = 0    # pool-failure counter at last health check
        self._last_steps_run = 0   # pool steps_run counter at last check


class ReplicaSet:
    """N serve engines behind one Scheduler-compatible facade, with
    cordon/requeue/restart failover.

    Parameters
    ----------
    factory:          ``factory(idx, metrics) -> engine`` building one
                      replica's engine against the SHARED metrics sink
                      (engines must support ``evict_active`` — the
                      force-field `EquivariantServeEngine` does).
    n_replicas:       fleet size.
    metrics:          shared `ServeMetrics` (created if None).
    clock:            injectable clock for scheduling/backoff (heartbeat
                      staleness uses wall time — the file format is
                      ``time.time`` based, shared with cluster probers).
    max_fail_streak:  consecutive failing rounds before cordoning.
    stale_after_s:    heartbeat-file age (seconds of wall time) past which
                      a replica is cordoned; None disables the check.
    restart_backoff_s: base of the exponential restart backoff.
    heartbeat_dir:    where heartbeat files live (a TemporaryDirectory is
                      created — and kept alive — if None).
    """

    def __init__(self, factory, n_replicas: int = 2, metrics=None,
                 clock=time.monotonic, max_fail_streak: int = 3,
                 stale_after_s: float | None = None,
                 restart_backoff_s: float = 1e-3,
                 heartbeat_dir: str | None = None):
        self.clock = clock
        self.metrics = metrics if metrics is not None \
            else ServeMetrics(clock=clock)
        self.max_fail_streak = max(1, int(max_fail_streak))
        self.stale_after_s = stale_after_s
        self.restart_backoff_s = restart_backoff_s
        if heartbeat_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="repro_hb_")
            heartbeat_dir = self._tmpdir.name
        self.replicas: list[_Replica] = []
        for i in range(n_replicas):
            r = _Replica(i, factory(i, self.metrics),
                         f"{heartbeat_dir}/replica{i}.json")
            r.heartbeat.beat(0, force=True)   # the file must exist to age
            self.replicas.append(r)
        self._queue = None          # AdmissionQueue, via attach_queue
        self._orphans: list = []    # evicted requests with no queue to rejoin

    # ---------------------------------------------------- scheduler protocol
    def attach_queue(self, queue) -> None:
        """Called by `Scheduler.__init__`: failover requeues go here."""
        self._queue = queue

    def validate(self, req):
        # validation is host-side and replica-independent: any engine's rules
        return self.replicas[0].engine.validate(req)

    def try_admit(self, req) -> bool:
        """Admit into the least-loaded LIVE replica that has room."""
        live = [r for r in self.replicas if r.live]
        for r in sorted(live, key=lambda r: (self._load(r), r.idx)):
            if r.engine.try_admit(req):
                req._replica = r.idx
                return True
        return False

    def has_active(self) -> bool:
        """Work in flight on a live replica, evicted requests awaiting
        re-admission, or queued work held up by a cordoned replica (the
        fleet will grow back — that work is schedulable, not invalid, so
        the scheduler's drain must keep pumping instead of mis-rejecting
        it; with no queued work a cordoned replica does NOT hold the set
        active — it restarts on the next round that needs it)."""
        if any(r.live and r.engine.has_active() for r in self.replicas) \
                or self._orphans:
            return True
        return (any(not r.live for r in self.replicas)
                and self._queue is not None and len(self._queue) > 0)

    def step(self, overlap=None) -> None:
        """One fleet round: restart checks, health checks, then one engine
        step per live replica (the scheduler's overlap callback runs with
        the first stepped replica, as in the single-engine stack)."""
        for r in self.replicas:
            if not r.live:
                self._maybe_restart(r)
        self._readmit_orphans()
        for r in self.replicas:
            if r.live and self._heartbeat_stale(r):
                self._cordon(r, "heartbeat_stale")
        stepped_overlap = False
        for r in self.replicas:
            if not r.live or not r.engine.has_active():
                continue
            t0 = self.clock()
            r.engine.step(overlap=None if stepped_overlap else overlap)
            stepped_overlap = True
            r.steps += 1
            r.straggler.record(r.steps, self.clock() - t0)
            self._health_check(r)
        if overlap is not None and not stepped_overlap:
            overlap()   # admissions must still run while the fleet is idle

    def run(self, requests: list) -> list:
        return Scheduler(self, clock=self.clock).run(requests)

    # ------------------------------------------------------------- internals
    @staticmethod
    def _load(r: _Replica) -> int:
        pools = getattr(r.engine, "pools", None)
        if pools is None:
            return 0
        return sum(p.n_active() for p in pools)

    @staticmethod
    def _fail_count(r: _Replica) -> int:
        return sum(p.failures for p in getattr(r.engine, "pools", ()))

    @staticmethod
    def _steps_run(r: _Replica) -> int:
        return sum(p.steps_run for p in getattr(r.engine, "pools", ()))

    def _health_check(self, r: _Replica) -> None:
        """Post-step verdict from the replica's own pool counters (the
        shared metrics sink cannot attribute failures per replica)."""
        failures = self._fail_count(r)
        steps_run = self._steps_run(r)
        new_failures = failures - r._last_failures
        progressed = steps_run > r._last_steps_run
        r._last_failures = failures
        r._last_steps_run = steps_run
        if new_failures > 0:
            r.fail_streak += 1
            if r.fail_streak >= self.max_fail_streak:
                self._cordon(r, "step_failures")
        elif progressed:
            # a clean, advancing round: healthy — beat the heartbeat file
            # (a cooldown no-op round proves nothing either way)
            r.fail_streak = 0
            r.heartbeat.beat(steps_run, force=True)

    def _heartbeat_stale(self, r: _Replica) -> bool:
        if self.stale_after_s is None:
            return False
        try:
            with open(r.heartbeat.path) as f:
                t = json.load(f)["t"]
        except (OSError, ValueError, KeyError):
            return True           # unreadable health file = unhealthy
        return time.time() - t > self.stale_after_s

    def _cordon(self, r: _Replica, reason: str) -> None:
        """Pull the replica out of rotation: evict its in-flight requests
        (restored to admission snapshots) back onto the queue at their
        original (priority, _seq) standing, schedule a backed-off restart."""
        r.live = False
        r.fail_streak = 0
        r.restart_at = self.clock() + self.restart_backoff_s * \
            (2.0 ** min(r.restarts, 6))
        evicted = r.engine.evict_active() \
            if hasattr(r.engine, "evict_active") else []
        for req in evicted:
            if self._queue is not None and hasattr(req, "_seq"):
                self._queue.requeue(req)
            else:
                self._orphans.append(req)
        self.metrics.observe_failover(r.name, reason, len(evicted))

    def _maybe_restart(self, r: _Replica) -> None:
        if self.clock() < r.restart_at:
            return
        # supervisor restart: same engine (host slot arrays and compiled
        # steps survive the cordon), fresh health state, forced heartbeat
        r.live = True
        r.restarts += 1
        r.fail_streak = 0
        r._last_failures = self._fail_count(r)
        r._last_steps_run = self._steps_run(r)
        r.heartbeat.beat(r._last_steps_run, force=True)
        self.metrics.observe_restart(r.name)

    def _readmit_orphans(self) -> None:
        if not self._orphans:
            return
        still: list = []
        for req in self._orphans:
            if not self.try_admit(req):
                still.append(req)
        self._orphans = still
