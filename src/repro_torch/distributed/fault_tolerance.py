"""Fault-tolerance plumbing: heartbeat, preemption trap, straggler monitor.

A copy of the reference's ``repro.distributed.fault_tolerance`` (it imports
no JAX, but the reference's package ``__init__`` does, so the port keeps
its own): `serve/replicas.py` writes a `Heartbeat` file per replica and
watches each replica's step times with a `StragglerMonitor`,
`serve/metrics.py` flags slow steps with one, and `train/loop.py` beats a
heartbeat, monitors its steps and checkpoints and stops when its
`PreemptionGuard` catches SIGTERM.
"""
from __future__ import annotations

import json
import os
import signal
import time
from collections import deque

__all__ = ["Heartbeat", "PreemptionGuard", "StragglerMonitor"]


class Heartbeat:
    """Writes {step, t} to a file the cluster health-checker watches."""

    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval = interval_s
        self._last = 0.0

    def beat(self, step: int, force: bool = False):
        now = time.time()
        if force or now - self._last >= self.interval:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "t": now, "pid": os.getpid()}, f)
            os.replace(tmp, self.path)
            self._last = now


class PreemptionGuard:
    """SIGTERM/SIGINT -> set flag; the train loop checkpoints and exits.
    ``uninstall`` puts the handlers that were there before back (the
    reference keeps its handler for the life of the process)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_exit = False
        self._signals = signals
        self._previous: dict = {}

    def install(self):
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, h in self._previous.items():
            signal.signal(s, h)
        self._previous.clear()

    def _handler(self, signum, frame):
        self.should_exit = True


class StragglerMonitor:
    """Flags steps slower than `factor` x rolling median (straggler
    mitigation hook: the launcher logs and can trigger re-balancing or host
    cordoning; serving tracks replicas with it — serve/replicas.py).

    ``flagged`` keeps only the most recent ``max_flagged`` events (a
    long-lived serving host flags forever; an unbounded list is a slow
    leak); ``total_flagged`` counts every flag ever raised and is what
    `ServeMetrics.summary()` folds in."""

    def __init__(self, window: int = 50, factor: float = 2.0,
                 max_flagged: int = 256):
        self.times = deque(maxlen=window)
        self.factor = factor
        self.flagged: deque[tuple[int, float]] = deque(maxlen=max_flagged)
        self.total_flagged = 0

    def record(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= 10:
            med = sorted(self.times)[len(self.times) // 2]
            slow = dt > self.factor * med
            if slow:
                self.flagged.append((step, dt))
                self.total_flagged += 1
        self.times.append(dt)
        return slow
