"""EquiformerV2 with the Gaunt Selfmix (`models.equiformer`) at a CPU size
(l_max 2, m_max 1, 8 channels, 2 heads, 2 blocks, a 6 x 6 grid) on seeded
weights: against the plain float64 reference of the benchmark's family
(`perfbench.equiformer_reference`), under rotations of the input and
rolls of the edge frame, served with ghost-padded slots, with ties at the
last neighbour place; and the serve engine's warmup keys, which
`MaceGaunt` gives exactly as the engine built them before."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from perfbench.families import equiformer as fam
from repro_torch.configs.gaunt_ff import EquiformerV2Config, gaunt_mace_ff
from repro_torch.core import engine as _engine
from repro_torch.core.so3 import rotation_matrix_zyz
from repro_torch.models import equiformer as eq
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine
from test_torch_serve_scale import _NoHostRoundTrip

TINY = dict(L=2, m_max=1, channels=8, n_layers=2, n_heads=2, attn_hidden=8, attn_alpha=4,
            attn_value=4, ffn_hidden=8, grid_res=6, edge_channels=8, n_gaussians=16)
SEED = 2 ** 32 + 17


def _cfg(**kw) -> dict:
    """The benchmark's configuration at the CPU size."""
    from perfbench import bench

    cfg = bench.config("equiformer_v2_gaunt")
    cfg["model"] = dict(cfg["model"], **TINY, chain_tune="heuristic", **kw)
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    wts = fam.make_weights(cfg, SEED, "cpu")
    model = fam.build(cfg, wts, "cpu")
    systems = [fam.molecules({}, n, 1, SEED) for n in (10, 14)]
    return cfg, wts, model, systems


def _rel(a, b, scale):
    return float((a.double() - b.double()).abs().max() / scale)


def test_matches_the_plain_reference(setup):
    """Energies within 1e-5 of their largest, forces within 1e-4 of their
    RMS: float32 against float64 through two blocks of about a hundred
    dependent operations each reads 1e-7 and 1e-6 here (and 7e-6 at the
    published widths), so the tiers leave tenfold room and still sit far
    below what a wrong term moves (order one)."""
    cfg, wts, model, systems = setup
    ref = fam.reference(cfg, wts, torch.float64, "cpu")
    for sp, pos in systems:
        sp, pos = torch.as_tensor(sp), torch.as_tensor(pos)
        mask = torch.ones(sp.shape)
        with torch.no_grad():
            e, f = model.energy_forces_masked(sp, pos, mask)
        er, fr = ref.energy_forces(sp, pos)
        assert _rel(e, er, er.abs().max()) < 1e-5
        assert _rel(f, fr, fr.pow(2).mean().sqrt()) < 1e-4
        assert float(fr.pow(2).mean().sqrt()) > 1e-4          # the forces are not ~0


def test_state_names_are_the_familys(setup):
    cfg, _, model, _ = setup
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("dtype_pick")} == fam.shapes(cfg["model"])


def test_rotation_leaves_energy_and_rotates_forces(setup):
    """The S^2 grid's pointwise activations alias under a rotation: at the
    6 x 6 grid the forces move by 9e-5 of their RMS (6e-7 at 12 x 12), so
    the tier is 5e-4; the energy reads only invariant channels."""
    _, _, model, systems = setup
    R = torch.as_tensor(rotation_matrix_zyz(0.3, 1.1, -0.7), dtype=torch.float32)
    for sp, pos in systems:
        sp, pos = torch.as_tensor(sp), torch.as_tensor(pos)
        e, f = model.energy_forces(sp, pos)
        e2, f2 = model.energy_forces(sp, pos @ R.T)
        assert _rel(e2, e, e.abs().max()) < 1e-5
        assert _rel(f2, f @ R.T, f.pow(2).mean().sqrt()) < 5e-4


@pytest.mark.parametrize("angle", [0.7, 2.0])
def test_roll_of_the_edge_frame_gives_the_same_output(setup, monkeypatch, angle):
    """Every map in the edge frame is an SO(2) map but the S^2 activation's
    grid, whose longitudes alias under a roll (7.6e-7 of the force RMS
    here): tier 2e-5."""
    _, _, model, systems = setup
    sp, pos = (torch.as_tensor(a) for a in systems[1])
    e, f = model.energy_forces(sp, pos)
    c, s = math.cos(angle), math.sin(angle)
    Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    align = eq.align_rotation
    monkeypatch.setattr(eq, "align_rotation", lambda u: Rz @ align(u))
    e2, f2 = model.energy_forces(sp, pos)
    assert _rel(e2, e, e.abs().max()) < 1e-5
    assert _rel(f2, f, f.pow(2).mean().sqrt()) < 2e-5


def test_ghost_slots_leave_real_slots_unchanged(setup):
    """Two systems served in one bucket of 16 atoms x 3 slots (ghost
    padding, one empty slot): each equals its own evaluation, and every
    output, a ghost's included, is finite."""
    _, _, model, systems = setup
    eng = EquivariantServeEngine(model, buckets=[(16, 3)], warmup=True)
    pool = eng.pools.pools[0]
    reqs = [EquivariantRequest(species=sp[0], pos=pos[0], rid=i)
            for i, (sp, pos) in enumerate(systems)]
    for r in reqs:
        assert pool.admit(r)
    pool.stage()
    e, f = pool.step_staged()
    assert torch.isfinite(e).all() and torch.isfinite(f).all()
    assert float(e[2]) == 0.0 and float(f[2].abs().max()) == 0.0
    for i, r in enumerate(reqs):
        n = len(r.species)
        e1, f1 = model.energy_forces(torch.as_tensor(r.species), torch.as_tensor(r.pos))
        assert abs(float(e[i]) - float(e1)) <= 1e-6 * abs(float(e1))
        assert _rel(f[i, :n], f1, f1.pow(2).mean().sqrt()) < 1e-5
        assert float(f[i, n:].abs().max()) == 0.0


def test_served_step_makes_no_host_round_trip(setup):
    """The CPU rehearsal of the bucket's capture: after a warm step, the
    forward-only step body makes no tensor from host data, reads nothing
    back and sizes nothing by the data."""
    _, _, model, systems = setup
    eng = EquivariantServeEngine(model, buckets=[(16, 2)], warmup=True)
    pool = eng.pools.pools[0]
    for i, (sp, pos) in enumerate(systems):
        assert pool.admit(EquivariantRequest(species=sp[0], pos=pos[0], rid=i))
    pool.stage()
    e0, f0 = pool.step_staged()
    with _NoHostRoundTrip():
        e1, f1 = pool._forward(*pool._inputs)
    assert torch.equal(e0, e1) and torch.equal(f0, f1)


def test_ties_at_the_last_place_are_decided_alike():
    """A cubic lattice has whole shells at one distance: with 4 neighbours
    a shell of 6 is cut, and program and reference keep the same 4 (the
    lower indices) and give the same outputs."""
    cfg = _cfg(max_neighbors=4)
    wts = fam.make_weights(cfg, SEED, "cpu")
    model = fam.build(cfg, wts, "cpu")
    ref = fam.reference(cfg, wts, torch.float64, "cpu")
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = torch.as_tensor(1.5 * grid[None], dtype=torch.float32)
    sp = torch.full((1, 27), 29)
    nbr, valid = eq.neighbor_graph(pos, torch.ones(1, 27), cfg["model"]["cutoff"], 4)
    rn, rv = ref._neighbours(pos)
    assert torch.equal(nbr, rn) and torch.equal(valid, rv)
    assert nbr[0, 13].tolist() == [4, 10, 12, 14]     # the centre's six at 1.5 A, cut to 4
    with torch.no_grad():
        e, f = model.energy_forces_masked(sp, pos, torch.ones(1, 27))
    er, fr = ref.energy_forces(sp, pos)
    assert _rel(e, er, er.abs().max()) < 1e-5
    assert _rel(f, fr, fr.pow(2).mean().sqrt()) < 1e-4


def test_compute_dtype_only_float32():
    """The model runs at float32 only: the configuration states its
    precision, and any other value is refused before a parameter is made."""
    with pytest.raises(ValueError, match="only 'float32'"):
        eq.EquiformerV2Gaunt(EquiformerV2Config(name="tiny", **TINY, compute_dtype="bfloat16"),
                             device="cpu")


def test_no_edges_no_nan(setup):
    """Atoms farther apart than the cutoff have no edge: a zero message
    from the attention, never a NaN from an empty softmax."""
    _, _, model, _ = setup
    pos = torch.tensor([[[0.0, 0.0, 0.0], [30.0, 0.0, 0.0], [60.0, 0.0, 0.0]]])
    e, f = model.energy_forces(torch.tensor([[1, 6, 8]]), pos)
    assert torch.isfinite(e).all() and float(f.abs().max()) == 0.0


def _mace_keys_as_before(model, slot_atoms):
    """The keys `EquivariantServeEngine.warmup` built inline before it asked
    the model (its code, as it was)."""
    cfg = model.cfg
    big = max(slot_atoms) * cfg.channels
    dts = model.storage_dtype(big, model.device)
    gate_opts = (False, True) if model.grid_gate_on(big, model.device) else (False,)
    keys = []
    if cfg.chain_tune == "measure" and not cfg.shard_data:
        for a in slot_atoms:
            rows = a * cfg.channels
            for d in dict.fromkeys(["float32", dts]):
                for g in gate_opts:
                    keys.append(((cfg.L,) * cfg.nu, cfg.L,
                                 dict(batch_hint=rows, share_hint=(0,) * cfg.nu, dtype=d,
                                      gate=g)))
    return keys


@pytest.mark.parametrize("kw", [
    dict(chain_tune="measure", grid_gate="on"),
    dict(chain_tune="measure", grid_gate="off", compute_dtype="bfloat16"),
    dict(chain_tune="measure", grid_gate="on", shard_data=True),
    dict(chain_tune="heuristic", grid_gate="on"),
], ids=["measure_gated", "measure_bf16", "shard_data", "heuristic"])
def test_mace_hands_warmup_the_keys_it_measured_before(kw):
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, channels=4, n_species=4, **kw),
                      device="cpu")
    slot_atoms = [2 * 6, 4 * 8, 2 * 16]
    assert model.serve_chain_keys(slot_atoms) == _mace_keys_as_before(model, slot_atoms)


def test_equiformer_warmup_measures_the_selfmix_key():
    """With chain_tune='measure' the engine's warmup times the Selfmix chain
    (L, L) -> L, shared operand, at the bucket's atoms x channels rows, so
    the captured step finds its pick."""
    cfg = EquiformerV2Config(name="tiny", **TINY, chain_tune="measure")
    model = eq.EquiformerV2Gaunt(cfg, device="cpu")
    assert model.serve_chain_keys([24]) == [
        ((2, 2), 2, dict(batch_hint=24 * 8, share_hint=(0, 0), dtype="float32", gate=False))]
    EquivariantServeEngine(model, buckets=[(12, 2)], warmup=True)
    ge = _engine.get_engine()
    key = ge.chain_measure_key((2, 2), 2, "float32", 24 * 8, (0, 0), False, "cpu")
    assert ge.measured_pick(key) is not None
