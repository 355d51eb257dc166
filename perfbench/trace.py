"""The traced window: ``torch.profiler`` over CPU and CUDA activity, reduced
to what the per-layer metrics and the result's ``breakdown`` read.

- busy: the union of the device's activity intervals (kernels, including
  those inside CUDA graph replays, copies and fills), so overlapping
  streams are not counted twice;
- window: the host clock from the profiler's start to its stop, each
  after a synchronisation;
- device time by operation name (the top ten for the breakdown);
- idle gaps: the intervals of the window in which nothing ran on the
  device, the longest 200 attributed to what the host was doing then (the
  benchmark's own span, and the innermost host operation inside it), and
  summed by that name.

`span_ms` reads the port's own spans (`repro_torch.spans`), which a traced
run switches on and snapshots at the trace mark: a span's device time a
step before the mark.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

__all__ = ["Tracer", "span", "idle_pct", "span_ms"]

SPAN_PREFIX = "pb."


def short(name: str, head: int = 100, tail: int = 57) -> str:
    """A long templated kernel name cut to its head and its tail, where
    instantiations differ (the element type of a copy, say)."""
    return name if len(name) <= head + tail + 3 else f"{name[:head]}...{name[-tail:]}"


def span(name: str):
    """A host span of the benchmark around a call into one layer."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def idle_pct(run: dict, kind: str):
    """The share of a ``kind`` run's traced window in which nothing ran on
    the device, in percent; None for a run of another kind or untraced."""
    tr = run.get("trace")
    if run["kind"] != kind or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def span_ms(run: dict, kind: str, name: str):
    """The device time of the port's span ``name`` a step, in ms, over the
    steps of a ``kind`` run before its trace mark (the snapshot
    ``run["spans"]``: {totals, steps}); None for a run of another kind,
    without the snapshot (spans off, or a program without them), or where
    the span took no device time."""
    snap = run.get("spans")
    if run["kind"] != kind or not snap or not snap["steps"]:
        return None
    t = snap["totals"].get(name)
    if not t or t["device_s"] <= 0:
        return None
    return 1e3 * t["device_s"] / snap["steps"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge [start, end] intervals sorted by start."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


class Tracer:
    """One traced window on ``device``: ``start()`` and ``stop()`` between
    steps, then ``summary()``."""

    def __init__(self, device="cuda"):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None

    @staticmethod
    def warm(device) -> None:
        """Start and stop the profiler once in set-up, so that its first
        start (CUPTI's initialisation) falls outside the window."""
        with torch.profiler.profile(activities=_activities(device)):
            torch.ones(1, device=device).add_(1)
            _sync(device)

    def start(self) -> None:
        _sync(self.device)
        self.prof = torch.profiler.profile(activities=_activities(self.device))
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """{window_s, busy_s, device_ops [[name, s]], idle_gaps [[name, s]],
        op_s {name: s}} of the traced window."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                # a host span's range on the device's timeline is no device work
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(SPAN_PREFIX)):
                    dev.append((tr.start, tr.end, short(e.name)))
            elif e.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, e.name))
        window_s = self.t1 - self.t0
        op_s: dict = collections.Counter()
        for s, e, name in dev:
            op_s[name] += (e - s) * 1e-6
        out = {"window_s": window_s, "busy_s": 0.0, "device_ops": [], "idle_gaps": [],
               "op_s": dict(op_s)}
        if not dev:
            return out
        iv = np.asarray(sorted((s, e) for s, e, _ in dev), dtype=np.float64)
        merged = _union(iv)
        out["busy_s"] = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6
        out["device_ops"] = [[k, v] for k, v in op_s.most_common(10)]
        out["idle_gaps"] = self._gaps(merged, host)
        return out

    @staticmethod
    def _gaps(merged: np.ndarray, host: list, top: int = 200) -> list:
        """The idle gaps between device activity, the ``top`` longest named
        by the host's activity at their middle, summed by name."""
        if len(merged) < 2 or not host:
            return []
        starts, ends = merged[1:, 0], merged[:-1, 1]
        gaps = np.stack([ends, starts], -1)
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:top]]
        hs = np.asarray([h[0] for h in host])
        he = np.asarray([h[1] for h in host])
        names = [h[2] for h in host]
        is_span = np.asarray([n.startswith(SPAN_PREFIX) for n in names])
        total: dict = collections.Counter()
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = (hs <= mid) & (he >= mid)
            label = "host: no traced op"
            if inside.any():
                idx = np.nonzero(inside)[0]
                spans = idx[is_span[idx]]
                ops = idx[~is_span[idx]]
                sp = names[spans[np.argmin(he[spans] - hs[spans])]] if len(spans) else "-"
                op = names[ops[np.argmin(he[ops] - hs[ops])]] if len(ops) else "-"
                label = short(f"{sp} > {op}")
            total[label] += (b - a) * 1e-6
        return [[k, v] for k, v in total.most_common(10)]
