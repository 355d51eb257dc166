"""The port's force-field serving: served == direct evaluation with inert
ghost slots, continuous batching, relaxation, and admission rejection."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(gaunt_mace_ff, channels=4, n_layers=1, L=2, L_edge=3,
                              n_species=4, chain_tune="measure", grid_gate="on")
    return MaceGaunt(cfg, device="cpu", generator=torch.Generator().manual_seed(1))


def _mol(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, n), (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)


def _direct(model, sp, pos):
    e, f = model.energy_forces(torch.as_tensor(sp), torch.as_tensor(np.asarray(pos)))
    return float(e), f.numpy()


def test_served_matches_direct_with_ghost_slots(model):
    """3 molecules of different sizes in 4 slots of 7 atoms: padding atoms
    and the empty slot change nothing."""
    eng = EquivariantServeEngine(model, n_slots=4, max_atoms=7, warmup=True)
    reqs = [EquivariantRequest(*_mol(n, n), rid=i) for i, n in enumerate((2, 5, 7))]
    out = eng.run(reqs)
    assert all(r.done and not r.rejected for r in out)
    assert eng.metrics.counters["steps"] == 1 and eng.slot_req == [None] * 4
    for r in out:
        e, f = _direct(model, r.species, r.pos)
        assert abs(r.energy - e) <= 3e-4 * max(1.0, abs(e))
        assert r.forces.shape == (len(r.species), 3)
        assert np.abs(r.forces - f).max() <= 3e-4 * np.abs(f).max()


def test_continuous_batching_drains_overflow(model):
    eng = EquivariantServeEngine(model, n_slots=2, max_atoms=6)
    reqs = [EquivariantRequest(*_mol(2 + i % 4, 10 + i), rid=i) for i in range(5)]
    out = eng.run(reqs)
    assert all(r.done for r in out) and eng.metrics.counters["completed"] == 5
    for r in out:
        e, _ = _direct(model, r.species, r.pos)
        assert abs(r.energy - e) <= 3e-4 * max(1.0, abs(e))


def test_relaxation_returns_evaluated_geometry(model):
    eng = EquivariantServeEngine(model, n_slots=1, max_atoms=6)
    sp, pos0 = _mol(4, 7)
    s = 1e4  # random-init forces are tiny; make the move visible
    req = EquivariantRequest(species=sp, pos=pos0.copy(), steps=2, step_size=s)
    out = eng.run([req])[0]
    _, f0 = _direct(model, sp, pos0)
    pos1 = pos0 + s * f0
    np.testing.assert_allclose(out.pos, pos1, rtol=1e-5, atol=1e-6)
    e1, f1 = _direct(model, sp, pos1)
    assert abs(out.energy - e1) <= 3e-4 * max(1.0, abs(e1))


@pytest.mark.parametrize("species,pos,reason", [
    (np.array([], np.int64), np.zeros((0, 3), np.float32), "invalid"),
    (np.array([0, 9]), np.zeros((2, 3), np.float32), "invalid"),
    (np.array([0, 1]), np.array([[0, 0, 0], [np.nan, 0, 0]], np.float32), "invalid"),
    (np.zeros(9, np.int64), np.zeros((9, 3), np.float32), "too_large"),
])
def test_invalid_requests_rejected_at_admission(model, species, pos, reason):
    eng = EquivariantServeEngine(model, n_slots=2, max_atoms=6)
    req = EquivariantRequest(species=species, pos=pos)
    assert eng.add_request(req)
    assert req.rejected and req.done and req.reject_reason.startswith(reason)
    assert eng.slot_req == [None, None]
