"""Atom-padded slot pools for force-field serving.

A `SlotPool` holds ``n_slots`` molecules of up to ``max_atoms`` atoms in
host arrays (species, positions, atom mask).  Empty slots and the padding of
small molecules are ghost atoms parked far outside any cutoff, so they
interact with nothing and their masked energies are zero.

A step evaluates every slot in one pass: the model runs on the stacked
[n_slots, max_atoms] batch and one backward of the sum of the masked slot
energies gives every slot's forces (the slots never interact, so this equals
the reference's per-slot ``vmap(value_and_grad)``).  The many-body chain of
each layer therefore sees n_slots * max_atoms * channels rows.

`begin_step` uploads the slot tensors and runs the evaluation (on CUDA the
kernels are queued asynchronously); `finish_step` copies the results to the
host — the blocking point — and retires finished requests or advances
relaxations.  Fault injection, retries and quarantine are not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["BucketSpec", "SlotPool"]


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One size bucket: molecules with ``n <= max_atoms`` atoms may land in
    any of its ``n_slots`` slots."""
    max_atoms: int
    n_slots: int = 4


class _Inflight:
    """A dispatched step whose results are not on the host yet."""
    __slots__ = ("active", "energy", "forces", "t0")

    def __init__(self, active, energy, forces, t0):
        self.active, self.energy, self.forces, self.t0 = active, energy, forces, t0


class SlotPool:
    """Fixed atom-padded slots for one size bucket."""

    def __init__(self, model, spec: BucketSpec, metrics):
        self.model = model
        self.spec = spec
        self.metrics = metrics
        self.device = model.device
        n_slots, max_atoms = spec.n_slots, spec.max_atoms
        self.slot_req: list[Optional[object]] = [None] * n_slots
        self.species = np.zeros((n_slots, max_atoms), np.int64)
        self.pos = np.asarray(self._parked(), np.float32)[None].repeat(n_slots, 0)
        self.mask = np.zeros((n_slots, max_atoms), np.float32)

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def n_active(self) -> int:
        return sum(1 for r in self.slot_req if r is not None)

    def _parked(self) -> np.ndarray:
        """Ghost-atom positions: distinct sites far outside any cutoff, so
        padded atoms interact with nothing (each other included)."""
        far = 1e4 * (1.0 + np.arange(self.spec.max_atoms, dtype=np.float32))
        return np.stack([far, np.zeros_like(far), np.zeros_like(far)], -1)

    def admit(self, req) -> bool:
        """Place a validated, fitting request into a free slot (host writes)."""
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
        return True

    def evaluate(self, species: np.ndarray, pos: np.ndarray, mask: np.ndarray):
        """Masked energies [S] and forces [S, n, 3] of a slot batch, on the
        model's device (not yet synchronised)."""
        dev = self.device
        sp = torch.as_tensor(species, device=dev)
        p = torch.as_tensor(pos, device=dev).requires_grad_(True)
        m = torch.as_tensor(mask, device=dev)
        e = self.model.energy_masked(sp, p, m)
        (g,) = torch.autograd.grad(e.sum(), p)
        return e.detach(), -g

    def warmup_step(self) -> None:
        """Evaluate the current (ghost-only at boot) slots once and wait."""
        e, f = self.evaluate(self.species, self.pos, self.mask)
        e.cpu(), f.cpu()

    def begin_step(self) -> Optional[_Inflight]:
        """Run one evaluation of every slot; None when no slot is active."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return None
        t0 = time.monotonic()
        e, f = self.evaluate(self.species, self.pos, self.mask)
        return _Inflight(active, e, f, t0)

    def finish_step(self, h: _Inflight) -> list:
        """Wait for the step, retire finished requests, advance relaxations.
        Returns the requests completed by this step."""
        e = h.energy.cpu().numpy()   # blocks until the device is done
        f = h.forces.cpu().numpy()
        self.metrics.observe_step(time.monotonic() - h.t0)
        completed = []
        for i in h.active:
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
                completed.append(req)
                self.metrics.observe_complete()
            elif req.step_size != 0.0:
                # relaxation: steepest descent on the masked energy
                self.pos[i, :n] += req.step_size * f[i, :n]
        return completed
