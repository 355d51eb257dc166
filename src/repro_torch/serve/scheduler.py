"""Admission and deadline scheduling for the serving engines.

The port's copy of the reference's ``repro.serve.scheduler``: the
continuous-batching discipline — admit while capacity is free, step until
everything drains — as a scheduler over an engine protocol (the LM
``ServeEngine``, the force-field ``EquivariantServeEngine`` and a
``ReplicaSet`` of them):

- **priority queue** — requests carry ``priority`` (lower value = more
  urgent) and are admitted in strict priority order, FIFO within a priority
  class.  A request whose capacity target is full (e.g. its size bucket has
  no free slot) is skipped WITHOUT blocking later requests that fit
  elsewhere — only same-destination requests behind it keep their FIFO
  position relative to it.
- **deadlines** — ``deadline`` is seconds of allowed queue wait from
  submission; a request still queued past it is **rejected with a
  structured reason** (``reject_reason='deadline_expired'``) instead of
  being silently padded into a batch whose result nobody is waiting for.
- **structured rejection** — admission-time validation failures (engine
  ``validate``: NaN geometry, zero step budgets, oversized molecules) mark
  the request ``rejected=True, reject_reason=...`` and complete it
  immediately; they never occupy a slot or poison a shared batched step.
- **overlap admission** — ``Scheduler.pump`` passes its own admission pass
  as the engine step's ``overlap`` callback, so queue pops, validation, and
  host-side slot writes for the NEXT step run while the CURRENT step's
  device computation is in flight.

Engines plug in through a four-method protocol: ``validate(req)``,
``try_admit(req)``, ``has_active()``, ``step(overlap=None)``.  The clock is
injectable (tests drive deadlines with a fake clock).
"""
from __future__ import annotations

import heapq
import time
from typing import Callable, Optional

from .. import spans

__all__ = ["AdmissionQueue", "Scheduler",
           "REASON_DEADLINE", "REASON_INVALID", "REASON_TOO_LARGE"]

REASON_DEADLINE = "deadline_expired"
REASON_INVALID = "invalid"
REASON_TOO_LARGE = "too_large"


def _deadline_expired(req, now: float) -> bool:
    dl = getattr(req, "deadline", None)
    sub = getattr(req, "_submit_t", None)
    return dl is not None and sub is not None and (now - sub) > dl


class AdmissionQueue:
    """Priority admission queue: strict ``priority`` (lower first), FIFO
    within a priority class (stable sequence numbers), deadline expiry."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._heap: list = []      # (priority, seq, req)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def submit(self, req, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        if getattr(req, "_submit_t", None) is None:
            req._submit_t = now
        req._seq = self._seq
        self._seq += 1
        heapq.heappush(self._heap,
                       (getattr(req, "priority", 0), req._seq, req))

    def requeue(self, req) -> None:
        """Put a popped-but-unadmittable request back at its ORIGINAL
        position (same priority, same sequence number): a full bucket must
        not cost a request its FIFO standing."""
        heapq.heappush(self._heap,
                       (getattr(req, "priority", 0), req._seq, req))

    def expire(self, now: Optional[float] = None) -> list:
        """Remove and return every queued request whose deadline has passed
        (the caller marks them rejected).  O(n) heap rebuild — admission
        queues are small next to a device step."""
        now = self._clock() if now is None else now
        expired = [r for _, _, r in self._heap if _deadline_expired(r, now)]
        if expired:
            self._heap = [e for e in self._heap
                          if not _deadline_expired(e[2], now)]
            heapq.heapify(self._heap)
        return expired

    def pop(self) -> Optional[object]:
        """Next request in (priority, FIFO) order, or None."""
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]


class Scheduler:
    """Continuous-batching drain over an engine's admission protocol.

    ``run(requests)`` is the closed-loop entry (submit everything, drain);
    open-loop load generators submit as arrivals happen and call ``pump()``
    per iteration.
    """

    def __init__(self, engine, clock=time.monotonic, metrics=None):
        self.engine = engine
        self.clock = clock
        self.queue = AdmissionQueue(clock)
        self.metrics = metrics if metrics is not None \
            else getattr(engine, "metrics", None)
        # engines that re-submit work (a ReplicaSet failing over a cordoned
        # replica's in-flight requests) need the queue to requeue into
        attach = getattr(engine, "attach_queue", None)
        if attach is not None:
            attach(self.queue)

    # ------------------------------------------------------------ admission
    def submit(self, req) -> None:
        now = self.clock()
        if self.metrics is not None:
            self.metrics.observe_submit(req, now)
        self.queue.submit(req, now)

    def _reject(self, req, reason: str, detail: str = "") -> None:
        req.rejected = True
        req.reject_reason = f"{reason}:{detail}" if detail else reason
        req.done = True
        if self.metrics is not None:
            self.metrics.observe_reject(req, reason)

    def admit_ready(self) -> int:
        """One admission pass: expire stale requests, then admit everything
        that fits right now, in (priority, FIFO) order.  Requests whose
        destination is full are requeued at their original position.

        Touches only host state (queue bookkeeping + slot-array writes), so
        the engine step may safely run it as the ``overlap`` callback while
        a device step is in flight.  Returns the number admitted."""
        with spans.span("admit"):
            return self._admit_ready()

    def _admit_ready(self) -> int:
        now = self.clock()
        for req in self.queue.expire(now):
            self._reject(req, REASON_DEADLINE,
                         f"queued {now - req._submit_t:.3f}s > "
                         f"deadline {req.deadline}s")
        admitted = 0
        blocked: list = []
        while True:
            req = self.queue.pop()
            if req is None:
                break
            if _deadline_expired(req, now):
                self._reject(req, REASON_DEADLINE)
                continue
            err = self.engine.validate(req)
            if err is not None:
                reason, detail = err if isinstance(err, tuple) else (err, "")
                self._reject(req, reason, detail)
                continue
            if self.engine.try_admit(req):
                admitted += 1
                if self.metrics is not None:
                    self.metrics.observe_admit(req, self.clock())
            else:
                blocked.append(req)
        for req in blocked:
            self.queue.requeue(req)
        return admitted

    # ------------------------------------------------------------ stepping
    def pump(self, poll: Optional[Callable[[], None]] = None) -> bool:
        """One scheduling iteration: admit what fits, then step the engine —
        handing `admit_ready` (plus the optional ``poll`` arrival hook) to
        the step as its overlap callback, so the next batch is built while
        the device computes the current one.  True while work remains."""
        with spans.span("pump"):
            return self._pump(poll)

    def _pump(self, poll) -> bool:
        def overlap():
            if poll is not None:
                poll()
            self.admit_ready()

        overlap()
        if self.engine.has_active():
            self.engine.step(overlap=overlap)
        return bool(len(self.queue)) or self.engine.has_active()

    def drain(self) -> None:
        while len(self.queue) or self.engine.has_active():
            made_progress = self.admit_ready() > 0
            if self.engine.has_active():
                self.engine.step(overlap=self.admit_ready)
            elif not made_progress and len(self.queue):
                # nothing running, nothing admitted, queue non-empty: every
                # queued request is unschedulable against an idle engine —
                # a validator hole, not a transient.  Reject rather than spin.
                req = self.queue.pop()
                self._reject(req, REASON_INVALID, "unschedulable on an idle engine")

    def run(self, requests: list) -> list:
        """Closed loop: submit everything, drain, hand the list back (each
        request is completed or structurally rejected in place)."""
        for r in requests:
            self.submit(r)
        self.drain()
        return requests
