"""Synthetic molecular force-field data (Lennard-Jones clusters), numpy.

The benchmark's own copy of ``repro_torch.data.molecules`` (held equal to
it at the same seed by a test), so that the molecules the benchmark sends
cannot move with the program: a jittered k x k x k lattice (k^3 >= n
sites, spacing 1.3) per cluster, resampled while its LJ forces or energy
are pathological.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lj_dataset", "lj_energy_forces"]


def lj_energy_forces(species, pos, eps_table, sig_table):
    """Pairwise LJ.  species [n], pos [n,3] -> (E, F [n,3])."""
    n = pos.shape[0]
    diff = pos[None, :, :] - pos[:, None, :]
    d2 = np.sum(diff**2, axis=-1) + np.eye(n)
    d = np.sqrt(d2)
    eps = eps_table[species][:, None] * eps_table[species][None, :]
    sig = 0.5 * (sig_table[species][:, None] + sig_table[species][None, :])
    x6 = (sig / d) ** 6
    emat = 4 * eps * (x6**2 - x6) * (1 - np.eye(n))
    E = 0.5 * np.sum(emat)
    dEdd = 4 * eps * (-12 * x6**2 + 6 * x6) / d * (1 - np.eye(n))
    F = np.zeros_like(pos)
    for i in range(n):
        grad = np.sum(dEdd[i][:, None] * (-diff[i]) / d[i][:, None], axis=0)
        F[i] = -grad
    return E, F


def lj_dataset(n_samples: int, n_atoms: int = 8, n_species: int = 4, seed: int = 0):
    """Returns dict of arrays: species [S,n], pos [S,n,3], energy [S],
    forces [S,n,3]."""
    rng = np.random.default_rng(seed)
    eps_table = rng.uniform(0.5, 1.5, n_species)
    sig_table = rng.uniform(0.7, 0.9, n_species)
    species = rng.integers(0, n_species, (n_samples, n_atoms))
    pos = np.empty((n_samples, n_atoms, 3))
    E = np.empty(n_samples)
    F = np.empty((n_samples, n_atoms, 3))
    k = 2
    while k ** 3 < n_atoms:
        k += 1
    grid = np.stack(np.meshgrid(*[np.arange(k)] * 3, indexing="ij"), -1).reshape(-1, 3)
    for s in range(n_samples):
        # jittered lattice keeps pairs off the singular core; resample any
        # configuration with pathological forces
        for _ in range(50):
            base = rng.normal(scale=0.08, size=(n_atoms, 3))
            pos[s] = grid[:n_atoms] * 1.3 + base
            E[s], F[s] = lj_energy_forces(species[s], pos[s], eps_table, sig_table)
            if np.abs(F[s]).max() < 25.0 and abs(E[s]) < 25.0:
                break
    return {
        "species": species.astype(np.int32),
        "pos": pos.astype(np.float32),
        "energy": E.astype(np.float32),
        "forces": F.astype(np.float32),
    }
