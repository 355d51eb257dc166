"""Charged N-body simulation (the SEGNN sanity-check task, Satorras et al.).

A copy of the reference's ``repro.data.nbody`` (numpy only): the same seed
gives the same arrays, bit for bit.

5 particles with +-1 charges, random initial state; leapfrog integration of
Coulomb dynamics; the model predicts positions after `horizon` steps.
"""
from __future__ import annotations

import numpy as np

__all__ = ["nbody_dataset"]


def _simulate(charge, pos, vel, steps: int, dt: float = 0.001):
    for _ in range(steps):
        diff = pos[None, :, :] - pos[:, None, :]
        d = np.linalg.norm(diff, axis=-1) + np.eye(len(charge))
        f = (charge[:, None] * charge[None, :])[:, :, None] * diff / (d**3)[:, :, None]
        acc = -np.sum(f * (1 - np.eye(len(charge)))[:, :, None], axis=1)
        vel = vel + dt * acc
        pos = pos + dt * vel
    return pos, vel


def nbody_dataset(n_samples: int, n_particles: int = 5, horizon: int = 500, seed: int = 0):
    rng = np.random.default_rng(seed)
    charge = rng.choice([-1.0, 1.0], (n_samples, n_particles))
    pos = rng.normal(scale=1.0, size=(n_samples, n_particles, 3))
    vel = rng.normal(scale=0.5, size=(n_samples, n_particles, 3))
    target = np.empty_like(pos)
    for s in range(n_samples):
        target[s], _ = _simulate(charge[s], pos[s], vel[s], horizon)
    return {
        "charge": charge.astype(np.float32),
        "pos": pos.astype(np.float32),
        "vel": vel.astype(np.float32),
        "target": target.astype(np.float32),
    }
