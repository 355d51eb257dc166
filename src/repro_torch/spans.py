"""Named spans at the port's layer boundaries: the host time and the device
time of each stage, inside a captured CUDA graph too.

``with span("conv", on=x): ...`` times a stage.  Spans are off by default,
and then `span` returns one shared no-op context: no event, no profiler
range, no allocation.  ``REPRO_TORCH_SPANS=1`` in the environment, read
once at import, switches them on, and so does `set_enabled` (tests).

A span that is on:

- opens ``torch.profiler.record_function("rt." + name)``, so it lands in a
  profiler's host timeline, on the clock of the device's kernel records;
- times its host duration (``time.perf_counter``);
- where ``on`` is a CUDA tensor, records a timing event on the current
  stream at its start and one at its end.  Eager events are resolved
  lazily (`totals` synchronises).  While a CUDA graph is captured inside
  `capture`, the events are external ones: each becomes an event-record
  node of the graph, which every replay records again, and `add_replay`
  after a replay's outputs are on the host adds each stage's device time
  inside the graph.  A graph holds such nodes only if spans were on at its
  capture.

Totals are kept by name: calls, host seconds, device seconds, and the self
time of each (the span's time less the part its child spans cover; a
device child counts against its nearest enclosing span that has device
time).  A span's parent is the span open around it; in a captured graph,
the spans open around the capture are nobody's parent.  `observe` adds a
host interval measured elsewhere (the serve pools' ``host_gap``).

Spans are entered from the thread that runs the model's forward and the
serving loop, which is one thread.  The names in use:

- model (`models.equivariant.MaceGaunt`): ``geometry``, ``radial``,
  ``conv``, ``mix``, ``manybody``, ``mb_mix``, ``readout``; inside
  ``conv``, the eSCN route's ``conv.rotate``, ``conv.to_fourier``,
  ``conv.filter``, ``conv.to_sh``, ``conv.rotate_back``
  (`core.engine.build_escn`), and a spectral pairwise product's
  ``conv.to_fourier``, ``conv.conv2d``, ``conv.to_sh`` (the general conv's);
- model (`models.equiformer.EquiformerV2Gaunt`): ``graph``,
  ``edge_embed``, ``attention``, ``ffn``, ``selfmix`` (each block's),
  ``heads``;
- served step (`serve.pools.SlotPool._forward`): ``evaluate``,
  ``energy``, ``force_backward`` (none for a model that gives its forces
  directly);
- host round: ``pump``, ``admit`` (`serve.scheduler`), ``stage``,
  ``replay``, ``wait_outputs``, ``retire``, ``host_gap``
  (`serve.pools`);
- training step (`train.loop.make_train_step`): ``loss``, ``param_grad``,
  ``clip``, ``optimizer``.

`serve.metrics.ServeMetrics.summary` reports every span's totals.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["span", "set_enabled", "totals", "reset", "capture", "add_replay", "observe"]

PREFIX = "rt."

_ENABLED = os.environ.get("REPRO_TORCH_SPANS", "") == "1"


class _Off:
    """The shared context of a span that is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Total:
    __slots__ = ("calls", "host_s", "host_self_s", "device_s", "device_self_s", "parents")

    def __init__(self):
        self.calls = 0
        self.host_s = self.host_self_s = self.device_s = self.device_self_s = 0.0
        self.parents: set = set()

    def as_dict(self) -> dict:
        return {"calls": self.calls, "host_s": self.host_s, "host_self_s": self.host_self_s,
                "device_s": self.device_s, "device_self_s": self.device_self_s,
                "parents": sorted(self.parents, key=lambda p: (p is not None, p or ""))}


_TOTALS: dict[str, _Total] = {}
_STACK: list = []          # the spans open now, innermost last
_PENDING: list = []        # eager (name, device parent, start event, end event)
_COLLECT = None            # the `_Capture` of the graph being captured
_RESET_AT = time.perf_counter()


def _total(name: str) -> _Total:
    t = _TOTALS.get(name)
    if t is None:
        t = _TOTALS[name] = _Total()
    return t


def _add_device(name: str, dparent, dev_s: float) -> None:
    t = _total(name)
    t.device_s += dev_s
    t.device_self_s += dev_s
    if dparent is not None:
        _total(dparent).device_self_s -= dev_s


class _Capture:
    """The event pairs of the spans recorded while one graph is captured."""
    __slots__ = ("base", "records")

    def __init__(self, base: int):
        self.base = base           # spans below this depth lie outside the graph
        self.records: list = []    # (name, parent, device parent, start, end)


class _Span:
    __slots__ = ("name", "on", "rf", "t0", "ev0", "parent", "dparent", "child_host", "col")

    def __init__(self, name: str, on):
        self.name, self.on = name, on

    def __enter__(self):
        col = _COLLECT
        inside = _STACK[col.base:] if col is not None else _STACK
        self.parent = inside[-1] if inside else None
        p = self.parent
        self.dparent = None if p is None else (p if p.ev0 is not None else p.dparent)
        self.child_host = 0.0
        self.ev0 = self.col = None
        _STACK.append(self)
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        dev = getattr(self.on, "device", None)
        if dev is not None and dev.type == "cuda":
            if not torch.cuda.is_current_stream_capturing():
                self.ev0 = torch.cuda.Event(enable_timing=True)
            elif col is not None:
                self.col = col
                self.ev0 = torch.cuda.Event(enable_timing=True, external=True)
            # a graph captured outside `capture` gets no event: nothing
            # would read it after a replay
            if self.ev0 is not None:
                self.ev0.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        ev1 = None
        if self.ev0 is not None and exc[0] is None:
            ev1 = torch.cuda.Event(enable_timing=True, external=self.col is not None)
            ev1.record()
        self.rf.__exit__(*exc)
        _STACK.pop()
        if exc[0] is not None:
            return False   # a stage that raised is not timed
        name, p = self.name, self.parent
        pname = None if p is None else p.name
        dpname = None if self.dparent is None else self.dparent.name
        t = _total(name)
        t.parents.add(pname)
        if self.col is not None:
            # a capture runs nothing: each replay adds a call and its times
            self.col.records.append((name, pname, dpname, self.ev0, ev1))
            return False
        t.calls += 1
        t.host_s += host_s
        t.host_self_s += host_s - self.child_host
        if p is not None:
            p.child_host += host_s
        if ev1 is not None:
            _PENDING.append((name, dpname, self.ev0, ev1))
            if not _STACK:
                _resolve(block=False)
        return False


def span(name: str, on=None):
    """A context that times the stage ``name``; its device time is taken on
    the current stream when ``on`` is a CUDA tensor (anything else: host
    time only)."""
    if not _ENABLED:
        return _OFF
    return _Span(name, on)


def set_enabled(flag: bool) -> bool:
    """Switch spans on or off; returns the previous setting."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(flag)
    return prev


def _resolve(block: bool) -> None:
    """Add the device times of the eager spans whose events are done (all
    of them with ``block``, waiting for each)."""
    done = 0
    for name, dparent, ev0, ev1 in _PENDING:
        if block:
            ev1.synchronize()
        elif not ev1.query():
            break
        _add_device(name, dparent, ev0.elapsed_time(ev1) * 1e-3)
        done += 1
    del _PENDING[:done]


def totals() -> dict:
    """{name: {calls, host_s, host_self_s, device_s, device_self_s,
    parents}} since the last `reset`; waits for the device to finish the
    spans recorded so far."""
    _resolve(block=True)
    return {name: t.as_dict() for name, t in _TOTALS.items()}


def reset() -> None:
    """Drop every total and every event not yet read."""
    global _RESET_AT
    _TOTALS.clear()
    _PENDING.clear()
    _RESET_AT = time.perf_counter()


@contextlib.contextmanager
def capture():
    """Around a CUDA graph's capture: yields the list that collects the
    event pairs of the spans recorded in it, for `add_replay` (empty when
    spans are off, and then the graph holds no event)."""
    global _COLLECT
    if not _ENABLED:
        yield []
        return
    prev, _COLLECT = _COLLECT, _Capture(len(_STACK))
    try:
        yield _COLLECT.records
    finally:
        _COLLECT = prev


def add_replay(records: list) -> None:
    """Add one replay's stage times: ``records`` from `capture`, read once
    the replay's outputs are on the host."""
    if not _ENABLED:
        return
    for name, parent, dparent, ev0, ev1 in records:
        t = _total(name)
        t.calls += 1
        t.parents.add(parent)
        _add_device(name, dparent, ev0.elapsed_time(ev1) * 1e-3)


def observe(name: str, start: float, end: float) -> None:
    """Add one host interval measured by the caller (``time.perf_counter``
    at each end); one that began before the last `reset` is not kept."""
    if not _ENABLED or start < _RESET_AT:
        return
    t = _total(name)
    t.calls += 1
    t.host_s += end - start
    t.host_self_s += end - start
    t.parents.add(None)
