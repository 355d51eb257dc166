"""The port's MaceGaunt against the reference with converted parameters —
energy and forces for grid_gate off/on x chain_tune heuristic/measure — and
its rotation symmetry and molecule batching on the port alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gaunt_ff import gaunt_mace_ff as ref_cfg
from repro.models.equivariant import MaceGaunt as RefMace
from repro.testing import assert_close
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.models.convert import params_from_jax
from repro_torch.models.equivariant import MaceGaunt

SMALL = dict(channels=4, n_layers=2, L=2, L_edge=3, n_species=4)


def _mol(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, n), (rng.normal(size=(n, 3)) * 1.2).astype(np.float32)


def _port(grid_gate="off", chain_tune="heuristic", seed=0):
    kw = dict(SMALL, grid_gate=grid_gate, chain_tune=chain_tune)
    ref = RefMace(dataclasses.replace(ref_cfg, **kw))
    params = ref.init(jax.random.PRNGKey(seed))
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return ref, params, model


def _close_forces(got, want, tol=3e-4):
    """Scale by the largest force: random-init forces are far below 1."""
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= tol * np.abs(np.asarray(want)).max(), err


@pytest.mark.parametrize("grid_gate", ["off", "on"])
@pytest.mark.parametrize("chain_tune", ["heuristic", "measure"])
def test_energy_forces_match_reference(grid_gate, chain_tune):
    ref, params, model = _port(grid_gate, chain_tune)
    sp, pos = _mol(5, 1)
    e_ref, f_ref = ref.energy_forces(params, jnp.asarray(sp), jnp.asarray(pos))
    e, f = model.energy_forces(torch.as_tensor(sp), torch.as_tensor(pos))
    assert_close(e.numpy(), np.asarray(e_ref), dtype="float32")
    _close_forces(f.numpy(), f_ref)


def test_converted_params_round_trip():
    ref, params, model = _port()
    sd = model.state_dict()
    # beside the parameters, the state holds the model's stored 'auto'
    # decisions, which the reference has no state for
    assert set(sd) == set(params_from_jax(jax.tree.map(np.asarray, params))) | {
        "grid_gate_pick", "dtype_pick"}
    assert np.array_equal(sd["layers.1.gate_w2"].numpy(),
                          np.asarray(params["layers"][1]["gate"]["w2"]))


@pytest.mark.parametrize("grid_gate", ["off", "on"])
def test_rotation_symmetry(grid_gate):
    """E(R pos) == E(pos) and F(R pos) == R F(pos) on the port."""
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **SMALL, grid_gate=grid_gate),
                      device="cpu", generator=torch.Generator().manual_seed(3))
    sp, pos = _mol(6, 2)
    q, _ = np.linalg.qr(np.random.default_rng(4).normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    e0, f0 = model.energy_forces(torch.as_tensor(sp), torch.as_tensor(pos))
    e1, f1 = model.energy_forces(torch.as_tensor(sp),
                                 torch.as_tensor((pos @ q.T).astype(np.float32)))
    assert_close(e1.numpy(), e0.numpy(), dtype="float32", tier="transform")
    _close_forces(f1.numpy(), f0.numpy() @ q.T, tol=5e-4)


def test_batched_molecules_equal_one_at_a_time():
    """A leading molecule axis evaluates each molecule independently — the
    property serving relies on for one backward over all slots."""
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **SMALL), device="cpu")
    mols = [_mol(5, s) for s in (5, 6)]
    sp = torch.as_tensor(np.stack([m[0] for m in mols]))
    pos = torch.as_tensor(np.stack([m[1] for m in mols]))
    e, f = model.energy_forces(sp, pos)
    for i, (s1, p1) in enumerate(mols):
        e1, f1 = model.energy_forces(torch.as_tensor(s1), torch.as_tensor(p1))
        assert_close(e[i].numpy(), e1.numpy(), dtype="float32")
        _close_forces(f[i].numpy(), f1.numpy())
