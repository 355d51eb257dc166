"""Serve cells: closed-loop clients through the port's
``EquivariantServeEngine`` and its ``Scheduler``.

Each client is one molecule (an MD walker or a screening worker): it sends
its next request only after its reply.  A request is one energy-and-forces
evaluation (``steps=1``) of the client's last geometry plus a Gaussian
displacement.  The mix file gives the atom counts (every count in
[lo, hi] equally often, the seed deciding which client gets which), the
species, the buckets (max_atoms, n_slots), the number of clients and the
displacement.  Every seed sends the same multiset of sizes.

Set-up: the weights and the molecules from the seed, the model, the
engine's warmup (the autotune cache, then every bucket's graph), and one
untimed round in which every client is served once.  The window then
measures ``seconds``, closing at the end of the first step past them:
clients stop sending then, and the requests in flight are drained.  With
``trace`` the window's last part runs under the profiler; the host-clock
readings of a traced run come from the part before it.  A request the
engine rejects counts as failed; its client goes on.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import check, work
from .lj import lj_dataset
from .trace import Tracer, span

__all__ = ["build_model", "make_clients", "run"]


def build_model(cfg: dict, weights: dict, device):
    """The port's MaceGaunt at the configuration, on ``weights`` (its chain
    picks persist where ``run.py`` points $REPRO_TORCH_AUTOTUNE_CACHE)."""
    from repro_torch.configs.gaunt_ff import EquivariantConfig
    from repro_torch.models.equivariant import MaceGaunt

    ec = EquivariantConfig(name=cfg["name"], kind="mace", **cfg["model"])
    model = MaceGaunt(ec, device=device)
    model.load_state_dict(weights)
    return model


class Client:
    """One walker: its species, its last geometry, its own random stream."""
    __slots__ = ("cid", "species", "pos", "rng", "k")

    def __init__(self, cid, species, pos, rng):
        self.cid, self.species, self.pos, self.rng, self.k = cid, species, pos, rng, 0

    def next_request(self, disp: float):
        from repro_torch.serve.engine import EquivariantRequest

        self.pos = (self.pos + self.rng.normal(0.0, disp, self.pos.shape)).astype(np.float32)
        self.k += 1
        return EquivariantRequest(species=self.species, pos=self.pos.copy(), steps=1,
                                  rid=self.cid * 1_000_000 + self.k)


def make_clients(mix: dict, seed: int) -> list:
    """The mix's clients for ``seed``: the same sizes for every seed, in an
    order and with geometries drawn from it."""
    lo, hi = mix["atoms"]
    sizes = np.random.default_rng([seed, 1]).permutation(
        np.resize(np.arange(lo, hi + 1), mix["clients"]))
    out = [None] * len(sizes)
    for n in np.unique(sizes):
        idx = np.nonzero(sizes == n)[0]
        d = lj_dataset(len(idx), int(n), mix["species"], seed=[seed, 3, int(n)])
        for j, c in enumerate(idx):
            out[c] = Client(int(c), d["species"][j].astype(np.int64), d["pos"][j],
                            np.random.default_rng([seed, 2, int(c)]))
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


def run(cell: dict, cfg: dict, mix: dict, lim: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float) -> tuple[dict, dict, dict]:
    """One run of a serve cell -> (result fields, checks, run record)."""
    from repro_torch.core import engine as ge
    from repro_torch.serve.engine import EquivariantServeEngine
    from . import weights as W

    device = torch.device(device)
    phases = {"start": time.perf_counter() - t_start}
    wts = W.make(cfg["model"], cfg["init"], seed, device)
    model = build_model(cfg, wts, device)
    phases["model"] = time.perf_counter() - t_start
    engine = EquivariantServeEngine(model, buckets=[tuple(b) for b in mix["buckets"]],
                                    warmup=True)
    phases["warmup"] = time.perf_counter() - t_start
    clients = make_clients(mix, seed)
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
    engine.metrics.reset()
    setup_s = time.perf_counter() - t_start

    records: list = []
    loop = Loop(engine, clients, mix["displacement"])
    t0 = time.perf_counter()
    t_close = t0 + seconds
    trace_from = t_close - min(mix["trace_seconds"], seconds / 2) if trace else None
    tracer = Tracer() if trace else None
    marks: dict = {}

    def on_pump():
        if tracer is None or tracer.t0 is not None or time.perf_counter() < trace_from:
            return
        marks.update(t=time.perf_counter(), n_wait=len(engine.metrics.queue_wait_s),
                     atoms=(engine.metrics.atoms_real, engine.metrics.atoms_padded),
                     replays=[p.replays for p in engine.pools])
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
           "model": cfg["model"], "marks": marks, "trace": None,
           "memory_peak_bytes": peak}
    if tracer is not None and tracer.t0 is not None:
        rec["trace"] = tracer.summary()
        rec["chain"] = _chain_bound(engine, cfg["model"], marks)
    # the program's state goes before the reference runs
    del engine, model, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    sample = check.sample_requests([r for r in records if not r["failed"]], seed)
    refs = check.reference_serve(cfg["model"], wts, sample, torch.float64, device)
    readings = check.serve_readings(sample, refs)
    print(f"perfbench: check of {len(sample)} requests "
          f"{time.perf_counter() - t_check:.2f} s", flush=True)
    checks = {k: {"value": readings[k], "limit": lim[k]} for k in lim}
    attempted = len(records)
    failed = sum(1 for r in records if r["failed"])
    result = {"correct": check.verdict(readings, lim) and failed == 0,
              "attempted": attempted, "failed": failed}
    return result, checks, rec


def _chain_bound(engine, model: dict, marks: dict) -> dict:
    """The least time of the chain kernel calls in the traced window: each
    bucket's replays there times its chain launches a replay, each call on
    the bucket's rows (n_slots x max_atoms x channels)."""
    total_s, launches = 0.0, 0
    for p, r0, r1 in zip(engine.pools, marks["replays"], marks["replays_end"]):
        per = p.launches.get("gaunt_chain", 0)
        rows = p.spec.n_slots * p.spec.max_atoms * model["channels"]
        f, b = work.chain_work(rows, model["L"], model["nu"], model["L"], gated=True)
        total_s += (r1 - r0) * per * work.bound_s(f, b)
        launches += (r1 - r0) * per
    return {"bound_s": total_s, "launches": launches}
