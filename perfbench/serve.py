"""Serve cells: closed-loop clients through the port's
``EquivariantServeEngine`` and its ``Scheduler``.

Each client is one molecule (an MD walker or a screening worker): it sends
its next request only after its reply.  A request is one energy-and-forces
evaluation (``steps=1``) of the client's first geometry plus a fresh
Gaussian displacement, so that no walker drifts however many requests it
sends.  The mix file gives the atom counts (every count in [lo, hi]
equally often, the seed deciding which client gets which), the species,
the buckets (max_atoms, n_slots), the number of clients and the
displacement.  Every seed sends the same multiset of sizes.  The
configuration's family gives the weights, the port's model, the molecules
and the reference (``FAMILY`` below).

Set-up: the weights and the molecules from the seed, the model, the
engine's warmup (the autotune cache, then every bucket's graph), and one
untimed round in which every client is served once.  The window then
measures ``seconds``, closing at the end of the first step past them:
clients stop sending then, and the requests in flight are drained.  With
``trace`` the window's last part runs under the profiler, and the port's
spans (on where ``run.py`` switched them on), reset where the window
opens, are snapshotted where that part begins; the host-clock readings of
a traced run come from the part before it.  A request the engine rejects
counts as failed; its client goes on.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import bench, check
from .trace import Tracer, span

__all__ = ["FAMILY", "Client", "make_clients", "run"]

# what a serve cell calls of its configuration's family, beside bench.FAMILY
FAMILY = ("molecules", "serve_flops", "kernel_bounds")


class Client:
    """One walker: its species, its first geometry, its own random stream."""
    __slots__ = ("cid", "species", "pos", "rng", "k")

    def __init__(self, cid, species, pos, rng):
        self.cid, self.species, self.pos, self.rng, self.k = cid, species, pos, rng, 0

    def next_request(self, disp: float):
        """The next request: the first geometry plus N(0, disp) in every
        coordinate, drawn anew (a bounded walk)."""
        from repro_torch.serve.engine import EquivariantRequest

        pos = (self.pos + self.rng.normal(0.0, disp, self.pos.shape)).astype(np.float32)
        self.k += 1
        return EquivariantRequest(species=self.species, pos=pos, steps=1,
                                  rid=self.cid * 1_000_000 + self.k)


def make_clients(family, mix: dict, seed: int) -> list:
    """The mix's clients for ``seed``: the same sizes for every seed, in an
    order and with the family's molecules drawn from it."""
    lo, hi = mix["atoms"]
    sizes = np.random.default_rng([seed, 1]).permutation(
        np.resize(np.arange(lo, hi + 1), mix["clients"]))
    out = [None] * len(sizes)
    for n in np.unique(sizes):
        idx = np.nonzero(sizes == n)[0]
        species, pos = family.molecules(mix, int(n), len(idx), seed)
        for j, c in enumerate(idx):
            out[c] = Client(int(c), species[j], pos[j], np.random.default_rng([seed, 2, int(c)]))
    return out


class Loop:
    """The closed loop over one engine and scheduler."""

    def __init__(self, engine, clients, disp):
        from repro_torch.serve.scheduler import Scheduler

        self.engine, self.clients, self.disp = engine, clients, disp
        self.sched = Scheduler(engine)
        self.pending: dict = {}     # client -> (request, submit time)
        self.closed_at = None       # the end of the pump that closed the window

    def submit(self, c, now):
        req = c.next_request(self.disp)
        self.pending[c.cid] = (c, req, now)
        self.sched.submit(req)

    def run(self, t_close: float, records: list | None, until_each: bool = False,
            on_pump=None, on_close=None) -> None:
        """Pump until ``t_close`` (or, with ``until_each``, until every
        client has been served once), then drain what is in flight;
        ``on_pump`` runs before each pump, ``on_close`` when the window
        closes."""
        now = time.perf_counter()
        for c in self.clients:
            self.submit(c, now)
        open_ = True
        while self.pending:
            if on_pump is not None:
                on_pump()
            with span("scheduler_pump"):
                self.sched.pump()
            now = time.perf_counter()
            if open_ and (until_each or now >= t_close):
                # the window closes at the end of the first step past its
                # length, so its completions and its time end together
                open_, self.closed_at = False, now
                if on_close is not None:
                    on_close()
            with span("clients"):
                for cid, (c, req, ts) in list(self.pending.items()):
                    if not req.done:
                        continue
                    del self.pending[cid]
                    if records is not None:
                        records.append({"species": c.species, "pos": req.pos,
                                        "energy": req.energy, "forces": req.forces,
                                        "failed": req.rejected, "t_sub": ts, "t_done": now})
                    if open_:
                        self.submit(c, now)


def run(cell: dict, cfg: dict, family, mix: dict, lim: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float) -> tuple[dict, dict, dict]:
    """One run of a serve cell -> (result fields, checks, run record)."""
    from repro_torch.core import engine as ge
    from repro_torch.serve.engine import EquivariantServeEngine

    device = torch.device(device)
    phases = {"start": time.perf_counter() - t_start}
    wts = family.make_weights(cfg, seed, device)
    model = family.build(cfg, wts, device)
    phases["model"] = time.perf_counter() - t_start
    engine = EquivariantServeEngine(model, buckets=[tuple(b) for b in mix["buckets"]],
                                    warmup=True)
    phases["warmup"] = time.perf_counter() - t_start
    clients = make_clients(family, mix, seed)
    phases["clients"] = time.perf_counter() - t_start
    Loop(engine, clients, mix["displacement"]).run(0.0, None, until_each=True)
    if trace:
        Tracer.warm(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["warm_round"] = time.perf_counter() - t_start
    print("perfbench: set-up s since start " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()}), flush=True)
    eng = ge.get_engine()
    timing_setup = eng.timing_runs
    spans = bench.port_spans()
    engine.metrics.reset()
    if spans is not None:
        spans.reset()
    setup_s = time.perf_counter() - t_start

    records: list = []
    loop = Loop(engine, clients, mix["displacement"])
    t0 = time.perf_counter()
    t_close = t0 + seconds
    trace_from = t_close - min(mix["trace_seconds"], seconds / 2) if trace else None
    tracer = Tracer(device) if trace else None
    marks: dict = {}
    snap = None

    def on_pump():
        nonlocal snap
        if tracer is None or tracer.t0 is not None or time.perf_counter() < trace_from:
            return
        marks.update(t=time.perf_counter(), n_wait=len(engine.metrics.queue_wait_s),
                     atoms=(engine.metrics.atoms_real, engine.metrics.atoms_padded),
                     replays=[p.replays for p in engine.pools])
        if spans is not None:
            totals = spans.totals()
            snap = {"totals": totals, "steps": totals.get("evaluate", {}).get("calls", 0)}
        tracer.start()

    def on_close():
        if tracer is not None and tracer.t0 is not None:
            tracer.stop()
            marks.update(replays_end=[p.replays for p in engine.pools])

    loop.run(t_close, records, on_pump=on_pump, on_close=on_close)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timing_window = eng.timing_runs - timing_setup
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"perfbench: engine timing_runs {eng.timing_runs} (set-up {timing_setup}, "
          f"window {timing_window})", flush=True)

    rec = {"kind": "serve", "setup_s": setup_s, "window_s": loop.closed_at - t0, "t0": t0,
           "t_close": loop.closed_at, "records": records, "metrics": engine.metrics,
           "family": family, "cfg": cfg, "marks": marks, "trace": None, "spans": snap,
           "memory_peak_bytes": peak}
    if tracer is not None and tracer.t0 is not None:
        rec["trace"] = tracer.summary()
        rec["kernels"] = family.kernel_bounds(cfg, [
            {"n_slots": p.spec.n_slots, "max_atoms": p.spec.max_atoms, "launches": p.launches,
             "replays": r1 - r0}
            for p, r0, r1 in zip(engine.pools, marks["replays"], marks["replays_end"])])
    # the program's state goes before the reference runs
    del engine, model, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    sample = check.sample_requests([r for r in records if not r["failed"]], seed)
    refs = check.reference_serve(family, cfg, wts, sample, torch.float64, device)
    readings = check.serve_readings(sample, refs)
    print(f"perfbench: check of {len(sample)} requests "
          f"{time.perf_counter() - t_check:.2f} s", flush=True)
    checks = {k: {"value": readings[k], "limit": lim[k]} for k in lim}
    attempted = len(records)
    failed = sum(1 for r in records if r["failed"])
    result = {"correct": check.verdict(readings, lim) and failed == 0,
              "attempted": attempted, "failed": failed}
    return result, checks, rec

