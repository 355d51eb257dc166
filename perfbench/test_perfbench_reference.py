"""The plain reference against the port's MaceGaunt on the CPU, at reduced
width, on seeded weights: energies, forces and the training loss's
gradients, for both convs."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench.families import mace
from perfbench.lj import lj_dataset
from perfbench.reference import Reference, gaunt, quadrature, real_sh

MODEL = dict(L=2, L_edge=3, channels=4, n_layers=2, nu=3, n_species=8, cutoff=5.0,
             n_radial=8, hidden=16, grid_gate="on")
INIT = {"species": {"std": 1.0}, "readout_w1": {"std": 0.5}, "readout_w2": {"std": 0.25},
        "radial_w1": {"std": 0.35}, "radial_w2": {"std": 4.0}, "mix": {"std": 0.5},
        "mb_mix": {"std": 0.5}, "mb_w": {"mean": 1 / 3, "std": 0.1},
        "gate_w1": {"std": 0.5}, "gate_w2": {"std": 0.18}}


def _port(conv, grid_gate, wts):
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.models.equivariant import MaceGaunt

    cfg = dataclasses.replace(gaunt_mace_ff, channels=MODEL["channels"], hidden=MODEL["hidden"],
                              conv_impl=conv, grid_gate=grid_gate)
    model = MaceGaunt(cfg, device="cpu")
    model.load_state_dict(wts)
    return model


def test_harmonics_orthonormal_under_the_quadrature():
    pts, w = quadrature(8)
    Y = real_sh(4, torch.from_numpy(pts)).numpy()
    assert np.abs(np.einsum("q,qa,qb->ab", w, Y, Y) - np.eye(25)).max() < 1e-12


def test_gaunt_tensor_is_symmetric_and_exact():
    """G(1, 1, 2) is symmetric in its first two indices, and Y00's row is
    the identity over 4 pi's root (Y_00 = 1 / sqrt(4 pi))."""
    G = gaunt(1, 1, 2)
    assert np.abs(G - G.transpose(1, 0, 2)).max() < 1e-14
    G0 = gaunt(0, 2, 2)[0]
    assert np.abs(G0 - np.eye(9) / np.sqrt(4 * np.pi)).max() < 1e-13


@pytest.mark.parametrize("conv", ["escn", "general"])
@pytest.mark.parametrize("grid_gate", ["on", "off"])
@pytest.mark.parametrize("seed", [1, 2 ** 33 + 5])
def test_energy_forces_match_the_port(conv, grid_gate, seed):
    wts = mace.make_weights({"model": dict(MODEL, grid_gate=grid_gate), "init": INIT}, seed,
                            "cpu")
    d = lj_dataset(2, 7, 4, seed=seed)
    sp, pos = torch.from_numpy(d["species"]).long(), torch.from_numpy(d["pos"])
    e, f = _port(conv, grid_gate, wts).energy_forces(sp, pos)
    er, fr = Reference(dict(MODEL, grid_gate=grid_gate), wts).energy_forces(sp, pos)
    assert float(fr.abs().max()) > 0.05       # forces of order one, not vanishing
    assert float((e.double() - er).abs().max() / er.abs().max()) < 1e-5
    assert float((f.double() - fr).abs().max() / fr.abs().max()) < 1e-4


def test_loss_gradients_match_the_port():
    wts = mace.make_weights({"model": MODEL, "init": INIT}, 7, "cpu")
    d = lj_dataset(2, 6, 4, seed=7)
    batch = {k: torch.from_numpy(v) for k, v in d.items()}
    model = _port("escn", "on", wts)
    loss = model.loss(batch)
    names = [k for k, _ in model.named_parameters()]
    gs = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    ref = Reference(MODEL, wts)
    w = {k: v.clone().requires_grad_(True) for k, v in ref.params().items()}
    lr = ref.loss(batch, w, 1.0, 10.0)
    gr = torch.autograd.grad(lr, [w[k] for k in names])
    assert abs(float(loss) - float(lr)) / abs(float(lr)) < 1e-5
    for k, a, b in zip(names, gs, gr):
        assert float((a.double() - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-3), k
