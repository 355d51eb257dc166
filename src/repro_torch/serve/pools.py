"""Size-bucketed slot pools for force-field serving, after the reference's
``repro.serve.pools``.

A `SlotPool` holds ``n_slots`` molecules of up to ``max_atoms`` atoms in
host arrays (species, positions, atom mask).  Empty slots and the padding
of small molecules are ghost atoms parked far outside any cutoff, so they
interact with nothing and their masked energies are zero.  `BucketedPools`
is the small/medium/large ladder: a request goes to the smallest bucket it
fits (`select`), so padding is bounded by the ladder, not by the
deployment's largest molecule.

A step evaluates every slot of a bucket in one pass: the model runs on the
stacked [n_slots, max_atoms] batch and one backward of the sum of the
masked slot energies gives every slot's forces (the slots never interact,
so this equals the reference's per-slot ``vmap(value_and_grad)``); a
model whose forward gives the forces (``energy_forces_masked``, the
EquiformerV2 family) runs forward only.  The
many-body chain of each layer therefore sees n_slots * max_atoms * channels
rows.

**The compiled step.**  The reference jits each bucket's step
(``jax.jit(vmap(value_and_grad))``, inputs donated).  Its counterpart on
CUDA is a CUDA graph of the bucket's step.  The pool owns static device
inputs (species [S, n] int64, pos [S, n, 3] f32 as a leaf that requires
grad, mask [S, n] f32) and captures `_forward` on them once, on the
bucket's first `warmup_compile` or `begin_step`: a bucket that sees no
traffic never captures.  Each step replays the graph; its outputs (energy
[S], forces [S, n, 3]) are static tensors in the graph's own memory pool,
so buckets in flight together never overwrite each other's results.
Before capture, warmup iterations on a side stream do every first-use side
effect (kernel builds, constant uploads, a chain pick not yet measured).
A capture that fails raises: on CUDA the served step is always the graph.
On the CPU there is no graph, and the pool builds its eager step on first
use (`compiled()` reports either).

`stage` copies the host arrays to the device inputs when they changed
since the last copy (on CUDA through pinned buffers, which are not
rewritten while a copy from them is pending).  `begin_step` stages and
dispatches the step (the device computes asynchronously); `finish_step`
copies the outputs to the host — the blocking point, before any later
replay of the bucket — and retires finished requests or advances
relaxations.  Between the two the engine runs the scheduler's admission
pass and stages other pools.

What a step is made of shows in the port's spans (`repro_torch.spans`):
with spans on at a bucket's capture, its graph holds a timed event pair
for each stage of `_forward` (``evaluate``, ``energy``, the model's
stages, ``force_backward``), read after each replay's blocking read; the
host's round shows as ``stage``, ``replay``, ``wait_outputs``,
``retire`` and ``host_gap``, the host's time from one step's blocking
read to the bucket's next dispatch, which `ServeMetrics.observe_host_gap`
keeps with spans off too.  A graph's kernel launches and basis
conversions are counted at each replay (`launches`, `conversions`).

Step-level fault tolerance: the host slot arrays are the source of truth,
so recovery from a failed step is cheap — mark the device inputs stale and
stage again.  A step that raises, exceeds the pool's watchdog deadline
(``step_timeout_s`` against the injectable clock), or returns non-finite
results enters `_on_step_failure`: every affected request restarts from
its admission snapshot (relaxations from step 0) up to its
``max_retries``, past which it is rejected with
``reject_reason='step_failed:<kind>'``; the pool backs off exponentially
(``retry_backoff_s``) before dispatching again.  Non-finite outputs
quarantine only the offending slots, and a batch that fails as a whole is
bisected into per-slot verdicts by evaluating masked sub-batches.  The
fault-injection points of `serve/faults.py` thread through both halves of
the step; they cost nothing unless a `FaultPlan` is installed.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from .. import spans
from ..core.rep import add_conversions, conversion_stats
from ..kernels.gaunt_fused import add_kernel_launches, kernel_stats
from . import faults

__all__ = ["BucketSpec", "SlotPool", "BucketedPools", "default_buckets"]

# eager iterations on a side stream before a capture (PyTorch's recipe)
_CAPTURE_WARMUP = 3


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One size bucket: molecules with ``n <= max_atoms`` atoms may land in
    any of its ``n_slots`` slots."""
    max_atoms: int
    n_slots: int = 4
    name: str = ""

    def label(self) -> str:
        return self.name or f"b{self.max_atoms}"


def default_buckets(max_atoms: int, n_slots: int = 4,
                    ladder=(4, 2, 1)) -> tuple[BucketSpec, ...]:
    """A small/medium/large ladder under a deployment cap: bucket sizes
    ``max_atoms // f`` for each ladder divisor (deduplicated, floor 2).
    ``default_buckets(256)`` -> 64/128/256; tiny caps collapse to fewer
    buckets (``default_buckets(2)`` is a single bucket)."""
    names = {0: "small", 1: "medium", 2: "large"}
    sizes = sorted({max(2, max_atoms // f) for f in ladder})
    n = len(sizes)
    return tuple(
        BucketSpec(sz, n_slots, names.get(i + (3 - n), f"b{sz}"))
        for i, sz in enumerate(sizes))


class _Inflight:
    """A dispatched step whose results are not on the host yet."""
    __slots__ = ("active", "energy", "forces", "t0")

    def __init__(self, active, energy, forces, t0):
        self.active, self.energy, self.forces, self.t0 = active, energy, forces, t0


class SlotPool:
    """Fixed atom-padded slots for one size bucket, with the bucket's own
    step: a CUDA graph on the card, the eager evaluation on the CPU."""

    def __init__(self, model, spec: BucketSpec, metrics=None,
                 clock=time.monotonic, step_timeout_s: float | None = None,
                 retry_backoff_s: float = 5e-4, tag: str = ""):
        self.model = model
        self.spec = spec
        self.metrics = metrics
        self.clock = clock
        self.step_timeout_s = step_timeout_s
        self.retry_backoff_s = retry_backoff_s
        self.tag = tag                 # fault-scope / replica label
        self.device = model.device
        n_slots, max_atoms = spec.n_slots, spec.max_atoms
        self.slot_req: list[Optional[object]] = [None] * n_slots
        self.species = np.zeros((n_slots, max_atoms), np.int64)
        self.pos = np.asarray(self._parked(), np.float32)[None].repeat(n_slots, 0)
        self.mask = np.zeros((n_slots, max_atoms), np.float32)
        self.steps_run = 0
        # recovery state
        self.failures = 0              # total failed steps (replica health)
        self._fail_streak = 0          # consecutive failures -> backoff
        self._cooldown_until = 0.0     # begin_step sits out until then
        self._failed_at = None         # first failure of the current outage
        self._built = False            # the step exists (graph captured on CUDA)
        self._staged = False           # the device inputs hold a copy
        self._dirty = True             # ... and the host arrays changed since
        # on CUDA: the graph, what its capture measured, and its replays
        self._graph = None
        self._outputs = None
        self.launches: dict = {}       # kernel launches per replay
        self.conversions: dict = {}    # basis conversions per replay
        self._span_events: list = []   # the graph's timed spans (spans on at capture)
        self._waited_at = None         # perf_counter at the end of the last blocking read
        self.capture_s: float | None = None
        self.graph_bytes: int | None = None
        self.replays = 0
        if self.device.type == "cuda":
            dev = self.device
            self._inputs = (torch.zeros((n_slots, max_atoms), dtype=torch.int64, device=dev),
                            torch.zeros((n_slots, max_atoms, 3), device=dev,
                                        requires_grad=True),
                            torch.zeros((n_slots, max_atoms), device=dev))
            self._pinned = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                 for t in self._inputs)
            self._copied = torch.cuda.Event()  # the last copy out of the pinned buffers
        else:
            self._inputs = None

    # ------------------------------------------------------------ queries
    def compiled(self) -> bool:
        """Whether this bucket's step exists: its graph is captured (CUDA),
        or its eager step built (CPU)."""
        return self._built

    def fits(self, n_atoms: int) -> bool:
        return n_atoms <= self.spec.max_atoms

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def n_active(self) -> int:
        return sum(1 for r in self.slot_req if r is not None)

    # ------------------------------------------------------------ slots
    def _parked(self) -> np.ndarray:
        """Ghost-atom positions: distinct sites far outside any cutoff, so
        padded atoms interact with nothing (each other included)."""
        far = 1e4 * (1.0 + np.arange(self.spec.max_atoms, dtype=np.float32))
        return np.stack([far, np.zeros_like(far), np.zeros_like(far)], -1)

    def admit(self, req) -> bool:
        """Place a validated, fitting request into a free slot; host writes
        only, safe while a step of the current slots is in flight.  The
        admission geometry is snapshotted on the request: a retried or
        failed-over request restarts from it, so a retry is idempotent."""
        free = self.free_slots()
        if not free:
            return False
        n = len(req.species)
        slot = free[0]
        self.species[slot] = 0
        self.species[slot, :n] = np.asarray(req.species, np.int64)
        self.pos[slot] = self._parked()
        self.pos[slot, :n] = np.asarray(req.pos, np.float32)
        self.mask[slot] = 0.0
        self.mask[slot, :n] = 1.0
        self.slot_req[slot] = req
        req._snap_pos = self.pos[slot, :n].copy()
        req._snap_steps = int(getattr(req, "steps", 1))
        self._dirty = True
        return True

    # ------------------------------------------------------------ the step
    def _forward(self, species, pos, mask):
        """Masked energies [S] and forces [S, n, 3] of a slot batch: one
        backward of the summed energies, or, for a model that gives its
        forces directly (``energy_forces_masked``), its forward pass alone
        under ``no_grad``.  The body each bucket's graph captures."""
        with spans.span("evaluate", pos):
            direct = getattr(self.model, "energy_forces_masked", None)
            if direct is not None:
                with torch.no_grad(), spans.span("energy", pos):
                    return direct(species, pos, mask)
            with spans.span("energy", pos):
                e = self.model.energy_masked(species, pos, mask)
            with spans.span("force_backward", pos):
                (g,) = torch.autograd.grad(e.sum(), pos)
            return e.detach(), -g

    def evaluate(self, species: np.ndarray, pos: np.ndarray, mask: np.ndarray):
        """The eager step on host slot arrays: masked energies [S] and forces
        [S, n, 3] on the model's device (not yet synchronised)."""
        dev = self.device
        return self._forward(torch.as_tensor(species, device=dev),
                             torch.as_tensor(pos, device=dev).requires_grad_(True),
                             torch.as_tensor(mask, device=dev))

    def _upload(self, species, pos, mask) -> None:
        """Copy slot arrays into the device inputs (asynchronously on CUDA)."""
        if self.device.type != "cuda":
            dev = self.device
            self._inputs = (torch.tensor(species, device=dev),
                            torch.tensor(pos, device=dev, requires_grad=True),
                            torch.tensor(mask, device=dev))
            return
        self._copied.synchronize()     # a pending copy may still read the pinned buffers
        for pin, a in zip(self._pinned, (species, pos, mask)):
            pin.numpy()[...] = a
        with torch.no_grad():
            for t, pin in zip(self._inputs, self._pinned):
                t.copy_(pin, non_blocking=True)
        self._copied.record()

    def stage(self, early: bool = False) -> None:
        """Copy the slot arrays to the device inputs if they changed since
        the last copy.  ``early=True`` is the pipelining overlap window
        (another pool's step in flight), counted so the overlap shows."""
        if self._staged and not self._dirty:
            return
        with spans.span("stage"):
            self._upload(self.species, self.pos, self.mask)
        self._staged, self._dirty = True, False
        if early and self.metrics is not None:
            self.metrics.observe_staged_early(self.spec.label())

    def _ensure_step(self) -> None:
        """Build the bucket's step on first use: capture its graph on CUDA;
        on the CPU the step is the eager evaluation.  A failed capture
        raises."""
        if self._built:
            return
        if self.device.type == "cuda":
            try:
                self._capture()
            except Exception as e:
                raise RuntimeError(f"bucket {self.spec.label()}: CUDA graph capture of the "
                                   f"step failed: {type(e).__name__}: {e}") from e
        self._built = True

    def _capture(self) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # builds, loads, constant uploads and chain picks happen here
            for _ in range(_CAPTURE_WARMUP):
                self._forward(*self._inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        # the cyclic collector must not run inside the capture: freeing
        # another graph there invalidates this one
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()   # as the capture does: its pool alone grows
            graph = torch.cuda.CUDAGraph()
            before, reserved = kernel_stats(), torch.cuda.memory_reserved(dev)
            conv_before = dict(conversion_stats())
            t0 = time.perf_counter()
            # no pool argument: the graph gets its own memory pool
            with spans.capture() as span_events, torch.cuda.graph(graph):
                outputs = self._forward(*self._inputs)
            torch.cuda.synchronize(dev)
            self.capture_s = time.perf_counter() - t0
            self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved
        finally:
            if collecting:
                gc.enable()
        after = kernel_stats()
        self.launches = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        # a capture records the kernels and launches none: only replays count
        add_kernel_launches({k: -v for k, v in self.launches.items()})
        conv_after = conversion_stats()
        self.conversions = {k: conv_after[k] - conv_before[k] for k in conv_after
                            if conv_after[k] != conv_before[k]}
        add_conversions({k: -v for k, v in self.conversions.items()})
        self._graph, self._outputs, self._span_events = graph, outputs, span_events

    def step_staged(self):
        """Run the bucket's step on the staged inputs -> (energy, forces)
        on the device; on CUDA the graph's static outputs, valid until the
        bucket's next replay."""
        self._ensure_step()
        if self._graph is None:
            return self._forward(*self._inputs)
        with spans.span("replay"):
            self._graph.replay()
        self.replays += 1
        add_kernel_launches(self.launches)
        add_conversions(self.conversions)
        return self._outputs

    def warmup_compile(self) -> None:
        """Build this bucket's step on its current (ghost-only at boot) slot
        contents and run it once, blocking — the per-bucket half of
        `EquivariantServeEngine.warmup()`, which retries transient failures
        (the injected kind raises here, before any device work)."""
        if faults._ACTIVE is not None and faults.fire(
                "compile_fail", tag=self.tag, pool=self.spec.label()) is not None:
            raise faults.InjectedFault(
                f"injected compile failure in bucket {self.spec.label()}")
        self.stage()
        e, f = self.step_staged()
        e.cpu(), f.cpu()

    def begin_step(self) -> Optional[_Inflight]:
        """Dispatch one evaluation of every active slot; returns an in-flight
        handle (the device computes asynchronously).  None while the pool
        is in retry backoff; dispatch-time exceptions (real or injected)
        enter step-failure recovery.  A failed graph capture raises."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return None
        if self._cooldown_until and self.clock() < self._cooldown_until:
            return None                  # retry backoff: sit this round out
        if faults._ACTIVE is not None and faults.fire(
                "step_raise", tag=self.tag, pool=self.spec.label(),
                n_active=len(active)) is not None:
            self._on_step_failure(active, "step_raised")
            return None
        self.stage()
        self._ensure_step()
        if self._waited_at is not None:
            # the host's time since the last blocking read, in which the
            # device had nothing of this bucket's to run (with no request
            # waiting, the wait for one too)
            now = time.perf_counter()
            if self.metrics is not None:
                self.metrics.observe_host_gap(self._waited_at, now)
            spans.observe("host_gap", self._waited_at, now)
            self._waited_at = None
        t0 = self.clock()
        try:
            e, f = self.step_staged()
        except Exception:
            self._on_step_failure(active, "step_raised")
            return None
        return _Inflight(active, e, f, t0)

    def finish_step(self, h: _Inflight) -> list:
        """Wait for the step, retire finished requests, advance relaxations.
        Returns the requests completed by this step.

        The recovery half of the watchdog lives here: an exception at the
        blocking read, a duration past ``step_timeout_s``, or non-finite
        outputs enter `_on_step_failure`; non-finite outputs quarantine only
        the offending slots (a batch that fails as a whole is bisected
        first)."""
        try:
            with spans.span("wait_outputs"):
                e = h.energy.cpu().numpy()   # blocks until the device is done
                f = h.forces.cpu().numpy()
        except Exception:
            self._on_step_failure(h.active, "step_raised")
            return []
        self._waited_at = time.perf_counter()
        if self._span_events:
            spans.add_replay(self._span_events)
        with spans.span("retire"):
            return self._retire(h, e, f)

    def _retire(self, h: _Inflight, e: np.ndarray, f: np.ndarray) -> list:
        """`finish_step` once the outputs are on the host."""
        dur = self.clock() - h.t0
        timed_out = (self.step_timeout_s is not None
                     and dur > self.step_timeout_s)
        if faults._ACTIVE is not None:
            if faults.fire("step_timeout", tag=self.tag,
                           pool=self.spec.label(),
                           n_active=len(h.active)) is not None:
                timed_out = True
            nf = faults.fire("step_nonfinite", tag=self.tag,
                             pool=self.spec.label(), n_active=len(h.active))
            if nf is not None:
                e = e.copy()
                f = f.copy()
                slots = nf.payload.get("slots", [0])
                rel = range(len(h.active)) if slots == "all" \
                    else [int(j) % len(h.active) for j in slots]
                for j in rel:
                    e[h.active[j]] = np.nan
                    f[h.active[j]] = np.nan
        if timed_out:
            self._on_step_failure(h.active, "step_timeout")
            return []
        self.steps_run += 1
        real_atoms = sum(len(self.slot_req[i].species) for i in h.active)
        if self.metrics is not None:
            self.metrics.observe_step(
                self.spec.label(), active=len(h.active),
                n_slots=self.spec.n_slots, real_atoms=real_atoms,
                padded_atoms=len(h.active) * self.spec.max_atoms,
                dur_s=dur)
        finite = {i: self._finite(e, f, i) for i in h.active}
        bad = [i for i in h.active if not finite[i]]
        if bad and len(bad) == len(h.active) and len(h.active) > 1:
            # the whole batch is non-finite: bisect into per-slot verdicts
            truly_bad = self._bisect_nonfinite(list(h.active))
            if truly_bad:
                self._on_step_failure(sorted(truly_bad), "nonfinite",
                                      quarantine=True)
            transient = [i for i in h.active if i not in truly_bad
                         and self.slot_req[i] is not None]
            if transient:
                # individually finite: the corruption was batch-level; a
                # plain retry, no quarantine accounting
                self._on_step_failure(transient, "nonfinite_collective")
            return []
        if bad:
            # per-slot quarantine: only the offending slots leave this
            # step's retirements; finite bucket-mates retire below
            self._on_step_failure(bad, "nonfinite", quarantine=True)
        completed = []
        good = [i for i in h.active if finite[i]]
        for i in good:
            req = self.slot_req[i]
            n = len(req.species)
            req.energy = float(e[i])
            req.forces = f[i, :n].copy()
            req.pos = self.pos[i, :n].copy()  # the evaluated geometry
            req.steps -= 1
            if req.steps <= 0:
                req.done = True
                self.slot_req[i] = None
                self.mask[i] = 0.0
                self._dirty = True
                completed.append(req)
                if self.metrics is not None:
                    self.metrics.observe_complete(req, self.clock())
            elif req.step_size != 0.0:
                # relaxation: steepest descent on the masked energy
                self.pos[i, :n] += req.step_size * f[i, :n]
                self._dirty = True
        if good:
            # the pool produced usable results: the outage (if any) is over
            self._fail_streak = 0
            self._cooldown_until = 0.0
            if self._failed_at is not None:
                if self.metrics is not None:
                    self.metrics.observe_recovery(self.clock() - self._failed_at)
                self._failed_at = None
        return completed

    # --------------------------------------------------------- recovery
    def _finite(self, e, f, i) -> bool:
        n = len(self.slot_req[i].species)
        return bool(np.isfinite(e[i]) and np.all(np.isfinite(f[i, :n])))

    def _bisect_nonfinite(self, slots: list) -> set:
        """Per-slot finite verdicts for a collectively non-finite batch, by
        evaluating masked sub-batches of the host slot arrays (on CUDA: the
        sub-batch mask goes into the graph's mask input and the graph
        replays; the inputs are then stale).  A group whose evaluation
        separates finite from non-finite slots is trusted; a group that
        fails as a whole again is split in half.  Returns the slots that are
        non-finite on their own."""
        evals = 0

        def verdicts(group):
            nonlocal evals
            evals += 1
            mask = np.zeros_like(self.mask)
            for i in group:
                mask[i, :len(self.slot_req[i].species)] = 1.0
            self._upload(self.species, self.pos, mask)
            self._dirty = True
            e, f = self.step_staged()
            e, f = e.cpu().numpy(), f.cpu().numpy()
            return {i: self._finite(e, f, i) for i in group}

        def bisect(group):
            v = verdicts(group)
            bad = [i for i in group if not v[i]]
            if len(group) == 1 or len(bad) < len(group):
                return set(bad)
            mid = len(group) // 2
            return bisect(group[:mid]) | bisect(group[mid:])

        bad = bisect(slots)
        if self.metrics is not None:
            self.metrics.observe_bisect(self.spec.label(), evals)
        return bad

    def _on_step_failure(self, slots: list, kind: str,
                         quarantine: bool = False) -> None:
        """Step-failure recovery for ``slots``: restart each affected
        request from its admission snapshot (or reject it past
        ``max_retries``), mark the device inputs stale, and back off
        exponentially before the next dispatch."""
        now = self.clock()
        if self._failed_at is None:
            self._failed_at = now
        self.failures += 1
        self._fail_streak += 1
        self._cooldown_until = now + self.retry_backoff_s * \
            (2.0 ** min(self._fail_streak - 1, 6))
        if self.metrics is not None:
            self.metrics.observe_step_failure(self.spec.label(), kind)
        for i in slots:
            req = self.slot_req[i]
            if req is None:
                continue
            if quarantine and self.metrics is not None:
                self.metrics.observe_quarantine(self.spec.label())
            req._retries = getattr(req, "_retries", 0) + 1
            if req._retries > max(0, int(getattr(req, "max_retries", 2))):
                req.rejected = True
                req.done = True
                req.reject_reason = f"step_failed:{kind}"
                req.energy = None
                req.forces = None
                if self.metrics is not None:
                    self.metrics.observe_reject(req, "step_failed")
                self.slot_req[i] = None
                self.mask[i] = 0.0
            else:
                if self.metrics is not None:
                    self.metrics.observe_retry(self.spec.label(), kind)
                self._restore_slot(i)
        # the host arrays are the source of truth: the next stage() copies
        # them to the device inputs again
        self._staged = False
        self._dirty = True

    def _restore_slot(self, i: int) -> None:
        """Reset slot ``i`` to its request's admission snapshot (idempotent
        retry: relaxation restarts from step 0 on the original geometry)."""
        req = self.slot_req[i]
        n = len(req.species)
        self.pos[i] = self._parked()
        self.pos[i, :n] = req._snap_pos
        req.steps = req._snap_steps
        req.energy = None
        req.forces = None

    def evict(self) -> list:
        """Pull every active request out of the pool (replica failover):
        each is restored to its admission snapshot and its slot freed, so
        the caller can requeue it elsewhere.  Retry counts survive — a
        failover does not launder a degenerate geometry's history."""
        evicted = []
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.pos = req._snap_pos.copy()
            req.steps = req._snap_steps
            req.energy = None
            req.forces = None
            self.slot_req[i] = None
            self.mask[i] = 0.0
            evicted.append(req)
        self._staged = False
        self._dirty = True
        return evicted


class BucketedPools:
    """The bucket ladder: pools sorted by ``max_atoms`` ascending; a request
    goes to the smallest bucket that fits it."""

    def __init__(self, model, specs, metrics=None, clock=time.monotonic,
                 step_timeout_s: float | None = None,
                 retry_backoff_s: float = 5e-4, tag: str = ""):
        specs = sorted(specs, key=lambda s: s.max_atoms)
        if len({s.max_atoms for s in specs}) != len(specs):
            raise ValueError(f"duplicate bucket sizes: {specs}")
        self.pools = [SlotPool(model, s, metrics=metrics, clock=clock,
                               step_timeout_s=step_timeout_s,
                               retry_backoff_s=retry_backoff_s, tag=tag)
                      for s in specs]

    def __iter__(self):
        return iter(self.pools)

    def __len__(self) -> int:
        return len(self.pools)

    @property
    def max_atoms(self) -> int:
        return self.pools[-1].spec.max_atoms

    def select(self, n_atoms: int) -> Optional[SlotPool]:
        """Smallest bucket with ``max_atoms >= n_atoms``; None if the
        request exceeds even the largest bucket."""
        for p in self.pools:
            if p.fits(n_atoms):
                return p
        return None

    def has_active(self) -> bool:
        return any(p.n_active() for p in self.pools)
