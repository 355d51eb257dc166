"""Serve observability: the port's `ServeMetrics`, after the reference's
``repro.serve.metrics``.

One `ServeMetrics` instance rides along an engine and its scheduler/pools:

- **per-request latency** — queue wait (submit→admit), service
  (admit→complete), and total (submit→complete), kept as raw second lists so
  any percentile can be asked for after the fact (`percentile`, `p50`/`p99`);
- **per-step gauges** — slot occupancy (active/total slots at each dispatched
  step) and padding waste (real atoms vs padded atom-slots the step actually
  computed on), both per pool and aggregated; the host gap before each
  dispatch (`observe_host_gap`: a pool's blocking read of one step to its
  next dispatch, on ``time.perf_counter``);
- **counters** — submissions, admissions, completions, structured rejections
  (`rejected:<reason>`), steps, early host-side stagings (the async-pipelining
  overlap hits);
- **fault tolerance** — step failures by kind
  (`step_failures:<kind>`), per-request retries, non-finite slot
  quarantines and bisect passes, replica failovers/restarts and requeued
  in-flight requests, straggler flags (a capped `StragglerMonitor` rides
  along), and time-to-recovery samples (failure detected → first successful
  step afterwards) with p50/p99 in `summary()`;
- **engine surfacing** — `summary()` snapshots the Gaunt engine's
  `timing_runs` counter (``engine_timing_runs``), so a serve deployment can
  see mid-traffic autotune timing passes (there must be none after warmup)
  without instrumenting the model, and the basis-conversion counters of
  `core/rep.py` (``conversions``; a bucket's graph adds its conversions at
  each replay), as the reference does;
- **spans** — with the port's spans on (`repro_torch.spans`), `summary()`
  gives each span's totals in the process: ``span:<name>:device_ms``,
  ``span:<name>:host_ms`` and ``span:<name>:calls``.

Everything is plain host-side Python (no device work, no locks — the serving
loop is single-threaded by design); a fake clock can be injected for tests.
"""
from __future__ import annotations

import collections
import time
from typing import Optional

from .. import spans as _spans
from ..core import engine as _engine
from ..core import rep as _rep
from ..distributed.fault_tolerance import StragglerMonitor

__all__ = ["ServeMetrics", "percentile"]


def percentile(xs, p: float) -> float:
    """Linear-interpolated percentile of a sequence (p in [0, 100])."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


class ServeMetrics:
    """Mutable metrics sink shared by a serve engine, its scheduler, and its
    slot pools.  All observation methods are cheap appends/increments."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.counters: collections.Counter = collections.Counter()
        # latency samples (seconds)
        self.queue_wait_s: list[float] = []
        self.service_s: list[float] = []
        self.total_s: list[float] = []
        self.step_s: list[float] = []
        # (end, seconds) of each host gap, and when the samples were reset
        self.host_gap: list[tuple[float, float]] = []
        self._reset_at = time.perf_counter()
        # per-step gauge samples
        self.occupancy: list[tuple[int, int]] = []   # (active, n_slots)
        self.atoms_real = 0        # sum over steps of real atoms evaluated
        self.atoms_padded = 0      # sum over steps of padded atom-slots
        self.per_pool: dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        # fault tolerance: time-to-recovery samples, the
        # completion sequence (failover ordering proofs read it), and a
        # capped straggler monitor fed by every observed step duration
        self.recovery_s: list[float] = []
        self.completed_order: collections.deque = collections.deque(
            maxlen=10_000)
        self.straggler = StragglerMonitor()

    def reset(self) -> None:
        """Zero every counter/sample (the load generator reuses one warmed
        engine across sweep points; compiled steps survive, numbers don't)."""
        self.counters.clear()
        self.queue_wait_s.clear()
        self.service_s.clear()
        self.total_s.clear()
        self.step_s.clear()
        self.host_gap.clear()
        self._reset_at = time.perf_counter()
        self.occupancy.clear()
        self.atoms_real = self.atoms_padded = 0
        self.per_pool.clear()
        self.recovery_s.clear()
        self.completed_order.clear()
        self.straggler = StragglerMonitor()

    # ------------------------------------------------------------ lifecycle
    def observe_submit(self, req, now: Optional[float] = None) -> None:
        req._submit_t = self.clock() if now is None else now
        self.counters["submitted"] += 1

    def observe_admit(self, req, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        req._admit_t = now
        sub = getattr(req, "_submit_t", None)
        if sub is not None:
            self.queue_wait_s.append(now - sub)
        self.counters["admitted"] += 1

    def observe_reject(self, req, reason: str) -> None:
        self.counters["rejected"] += 1
        self.counters[f"rejected:{reason}"] += 1

    def observe_complete(self, req, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        sub = getattr(req, "_submit_t", None)
        adm = getattr(req, "_admit_t", None)
        if sub is not None:
            self.total_s.append(now - sub)
        if adm is not None:
            self.service_s.append(now - adm)
        self.counters["completed"] += 1
        self.completed_order.append(getattr(req, "rid", None))

    # ------------------------------------------------------------ stepping
    def observe_step(self, pool: str, active: int, n_slots: int,
                     real_atoms: int, padded_atoms: int,
                     dur_s: float) -> None:
        self.counters["steps"] += 1
        self.step_s.append(dur_s)
        self.occupancy.append((active, n_slots))
        self.atoms_real += real_atoms
        self.atoms_padded += padded_atoms
        pc = self.per_pool[pool]
        pc["steps"] += 1
        pc["active_slots"] += active
        pc["atoms_real"] += real_atoms
        pc["atoms_padded"] += padded_atoms
        if self.straggler.record(self.counters["steps"], dur_s):
            self.counters["straggler_steps"] += 1
            pc["straggler_steps"] += 1

    def observe_host_gap(self, start: float, end: float) -> None:
        """A pool's host seconds from its last blocking read to its next
        dispatch (``time.perf_counter`` at each end); a gap that began
        before the last `reset` belongs to no window and is not kept."""
        if start >= self._reset_at:
            self.host_gap.append((end, end - start))

    # ------------------------------------------------------ fault tolerance
    def observe_step_failure(self, pool: str, kind: str) -> None:
        """A pool step raised, timed out, or returned unusable results and
        entered recovery (host-state rebuild + per-request retry)."""
        self.counters["step_failures"] += 1
        self.counters[f"step_failures:{kind}"] += 1
        self.per_pool[pool]["step_failures"] += 1

    def observe_retry(self, pool: str, kind: str) -> None:
        """One request re-queued in its slot for another attempt (restarted
        from its admission geometry snapshot — retry is idempotent)."""
        self.counters["retries"] += 1
        self.counters[f"retries:{kind}"] += 1
        self.per_pool[pool]["retries"] += 1

    def observe_quarantine(self, pool: str) -> None:
        """One slot's results were non-finite and ONLY that slot was pulled
        from the step's retirements (bucket-mates keep their numbers)."""
        self.counters["quarantined"] += 1
        self.per_pool[pool]["quarantined"] += 1

    def observe_bisect(self, pool: str, evals: int) -> None:
        """A collectively non-finite batch was bisected into per-slot
        verdicts (``evals`` extra sub-batch evaluations)."""
        self.counters["nonfinite_bisects"] += 1
        self.counters["nonfinite_bisect_evals"] += evals
        self.per_pool[pool]["nonfinite_bisects"] += 1

    def observe_recovery(self, dur_s: float) -> None:
        """Time-to-recovery: first failure detection in a pool → its next
        successful step (includes retry backoff, honest end-to-end)."""
        self.recovery_s.append(dur_s)

    def observe_failover(self, replica, reason: str, n_requeued: int) -> None:
        self.counters["failovers"] += 1
        self.counters[f"failovers:{reason}"] += 1
        self.counters["requeued_on_failover"] += n_requeued

    def observe_restart(self, replica) -> None:
        self.counters["replica_restarts"] += 1

    def observe_staged_early(self, pool: str) -> None:
        """A pool's next-step tensors were staged on the host while another
        step was in flight on the device (the pipelining overlap win)."""
        self.counters["staged_early"] += 1
        self.per_pool[pool]["staged_early"] += 1

    # ------------------------------------------------------------ derived
    def padding_efficiency(self) -> float:
        """Real atoms / padded atom-slots over every dispatched step — 1.0
        means no ghost-atom compute at all; a 12-atom molecule padded into a
        256-atom slot scores 0.047."""
        if self.atoms_padded == 0:
            return 1.0
        return self.atoms_real / self.atoms_padded

    def occupancy_mean(self) -> float:
        if not self.occupancy:
            return 0.0
        return sum(a for a, _ in self.occupancy) / \
            max(1, sum(n for _, n in self.occupancy))

    def summary(self) -> dict:
        """One flat dict for logging / bench records — latency percentiles,
        gauges, counters, and the engine's autotune timing runs, the
        conversion counters and the span totals snapshotted at call time
        (the spans' read waits for the device)."""
        out = {
            "submitted": self.counters["submitted"],
            "admitted": self.counters["admitted"],
            "completed": self.counters["completed"],
            "rejected": self.counters["rejected"],
            "steps": self.counters["steps"],
            "staged_early": self.counters["staged_early"],
            "queue_wait_p50_ms": percentile(self.queue_wait_s, 50) * 1e3,
            "queue_wait_p99_ms": percentile(self.queue_wait_s, 99) * 1e3,
            "latency_p50_ms": percentile(self.total_s, 50) * 1e3,
            "latency_p99_ms": percentile(self.total_s, 99) * 1e3,
            "step_p50_ms": percentile(self.step_s, 50) * 1e3,
            "step_p99_ms": percentile(self.step_s, 99) * 1e3,
            "occupancy_mean": self.occupancy_mean(),
            "padding_efficiency": self.padding_efficiency(),
            # fault tolerance
            "step_failures": self.counters["step_failures"],
            "retries": self.counters["retries"],
            "quarantined": self.counters["quarantined"],
            "nonfinite_bisects": self.counters["nonfinite_bisects"],
            "failovers": self.counters["failovers"],
            "replica_restarts": self.counters["replica_restarts"],
            "requeued_on_failover": self.counters["requeued_on_failover"],
            "straggler_steps": self.straggler.total_flagged,
            "recovery_p50_ms": percentile(self.recovery_s, 50) * 1e3,
            "recovery_p99_ms": percentile(self.recovery_s, 99) * 1e3,
        }
        for name, pc in self.per_pool.items():
            out[f"pool:{name}:steps"] = pc["steps"]
            if pc["atoms_padded"]:
                out[f"pool:{name}:padding_efficiency"] = \
                    pc["atoms_real"] / pc["atoms_padded"]
        for k, v in self.counters.items():
            if k.startswith(("rejected:", "step_failures:", "retries:",
                             "failovers:")):
                out[k] = v
        # engine-side counters: mid-serve timing passes (zero after warmup)
        # and basis conversions
        out["engine_timing_runs"] = _engine.get_engine().timing_runs
        out["conversions"] = dict(_rep.conversion_stats())
        for name, t in _spans.totals().items():
            out[f"span:{name}:device_ms"] = t["device_s"] * 1e3
            out[f"span:{name}:host_ms"] = t["host_s"] * 1e3
            out[f"span:{name}:calls"] = t["calls"]
        return out
