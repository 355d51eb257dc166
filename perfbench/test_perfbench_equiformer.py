"""The EquiformerV2 family (`families/equiformer.py`): its weights and slab
systems pinned by checksum, its model FLOPs and chain bounds counted by
hand at the CPU size, the slab rule's promise of 20 neighbours, and its
cell driven through the harness at the CPU size: correct when sound, not
correct with the answer altered where it is produced or with the Selfmix
chain at fault; and, on the card, the TF32 control and the faulty chain
failing the cell's limits."""
import time

import numpy as np
import pytest
import torch

from perfbench import bench, run, serve, work
from perfbench.families import equiformer as fam
from perfbench.test_perfbench_families import _digest

SEED = 2 ** 32 + 11
CELL = "equiformer_v2_gaunt.s2ef_oc20"
TINY = dict(L=2, m_max=1, channels=8, n_layers=2, n_heads=2, attn_hidden=8, attn_alpha=4,
            attn_value=4, ffn_hidden=8, grid_res=6, edge_channels=8, n_gaussians=16)


def _tiny_cfg() -> dict:
    cfg = bench.config("equiformer_v2_gaunt")
    cfg["model"] = dict(cfg["model"], **TINY)
    return cfg


@pytest.fixture
def tiny_cell(monkeypatch):
    """The cell at a CPU size: the tiny model, 4 clients of 10-12 atoms on
    one bucket of 12 atoms x 2 slots; the limits are the cell's own."""
    base_config, base_traffic = bench.config, bench.traffic

    def config(name):
        c = base_config(name)
        if c["family"] == "equiformer":
            c["model"] = dict(c["model"], **TINY, chain_tune="heuristic")
        return c

    def traffic(name):
        t = base_traffic(name)
        if name == "s2ef_oc20":
            t.update(atoms=[10, 12], clients=4, buckets=[[12, 2]])
        return t

    monkeypatch.setattr(bench, "config", config)
    monkeypatch.setattr(bench, "traffic", traffic)


# computed with this family's first version
def test_weights_pinned():
    w = fam.make_weights(_tiny_cfg(), SEED, "cpu")
    assert _digest([w[k] for k in sorted(w)]) == (
        "e825162ef591c46d266f5aa668e48ee4c9912114ee480d02ee0b691a800ff786")


@pytest.mark.parametrize("n,digest", [
    (12, "b48549d1a3c613d838b44422484bc1ff73649fbe11eeed256300acab39f83133"),
    (78, "0f1028e4e91eef365b2a3765c4d9c33046ca4ec32fdb5b9388a88e8c81516909"),
])
def test_slabs_pinned(n, digest):
    assert _digest(fam.molecules({}, n, 2, SEED)) == digest


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 3_000_000_000])
def test_every_atom_finds_its_neighbours(seed):
    """The cut of periodic images keeps the published graph: at every size
    of the mix each atom has at least 20 others within 12 A, and no two
    atoms are closer than 1.0 A."""
    mix = bench.traffic("s2ef_oc20")
    for n in range(mix["atoms"][0], mix["atoms"][1] + 1):
        sp, pos = fam.molecules(mix, n, 2, seed)
        d = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
        np.einsum("sii->si", d)[:] = np.inf
        assert ((d < 12.0).sum(-1) >= 20).all()
        assert d.min() >= 1.0 - 1e-5
        assert set(np.unique(sp)) <= {1, 6, 7, 8, 29, 46, 47, 78, 79}


def test_serve_flops_by_hand():
    """At the CPU size (L 2, M 1, C 8, 2 heads of 4 alpha and 4 value
    channels, attn_hidden 8, ffn_hidden 8, a 6 x 6 grid, 16 Gaussians, 8
    edge channels, 2 blocks) and 5 atoms (5 x 4 edges), multiply-adds:

    - an attention edge: radial 16+16=32 -> 8 -> 8 -> 80 (320 + 640),
      rotation of 16 channels in (1 + 9 + 15 = 25 a channel: 400), conv 1
      (m=0: 48 x 40 = 1920; m=1: 2 x 32 x 32 = 2048), grid 2 x 36 x 7 x 8
      (4032), conv 2 (m=0: 24 x 24 = 576; m=1: 2 x 16 x 32 = 1024),
      rotation back of 8 channels (200), alpha dot (8): 11,168;
    - an FFN atom: lin 1 (9 x 8 x 8 = 576), scalar (64), grids (2 x 36 x 9
      x 8 = 5184), grid MLP (3 x 36 x 64 = 6912), lin 2 (72 a channel out);
    - a block atom beside: attention's output map (576), Selfmix's mix
      (576), and its chain (`work.chain_work`, FLOPs) and weights (144);
    - the embedding edge: radial to 24 (512) and the m = 0 rotation (72)."""
    nnz, pairs = work.gaunt_nonzeros(2, 2, 2)
    attention_edge = 960 + 400 + 1920 + 2048 + 4032 + 576 + 1024 + 200 + 8
    ffn = 576 + 64 + 5184 + 6912
    macs = (2 * (20 * attention_edge + 5 * (576 + ffn + 576 + 576))
            + 20 * attention_edge + 5 * (72 + ffn + 72) + 20 * (512 + 72))
    chain = 8 * (pairs + 2 * nnz)
    assert fam.serve_flops(_tiny_cfg(), 5) == 2 * macs + 2 * 5 * (chain + 144)


def test_kernel_bounds_by_hand():
    """Each bucket's replays times its chain launches a replay, each call
    the 2-operand ungated chain at its least time on the bucket's rows;
    other kernels' launches are not the chain's."""
    cfg = {"model": {"channels": 4, "L": 2}}
    buckets = [{"n_slots": 2, "max_atoms": 8, "replays": 3,
                "launches": {"gaunt_chain": 2, "direct_conv": 2}},
               {"n_slots": 4, "max_atoms": 6, "replays": 0, "launches": {"gaunt_chain": 2}}]
    got = fam.kernel_bounds(cfg, buckets)["gaunt_chain"]
    f, b = work.chain_work(2 * 8 * 4, 2, 2, 2, gated=False)
    assert got["launches"] == 6
    assert got["bound_s"] == pytest.approx(6 * work.bound_s(f, b), rel=1e-15)


def test_clients_are_the_mixs_sizes():
    """32 clients, every size of 70-86 about as often, each a slab system."""
    mix = bench.traffic("s2ef_oc20")
    clients = serve.make_clients(fam, mix, SEED)
    sizes = sorted(len(c.species) for c in clients)
    assert len(clients) == 32 and sizes[0] == 70 and sizes[-1] == 86
    assert max(np.bincount(sizes)) == 2


def _run(**kw):
    res, checks, _ = run.run_cell(CELL, SEED, 0.4, False, "cpu", time.perf_counter(), **kw)
    return res, checks


def test_cell_sound_path_is_correct(tiny_cell):
    res, checks = _run()
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0


def test_cell_altered_answer_is_not_correct(tiny_cell, monkeypatch):
    from repro_torch.serve.pools import SlotPool

    sound = SlotPool._forward

    def forward(self, species, pos, mask):
        e, f = sound(self, species, pos, mask)
        return e, torch.cat([f[:1] * 1.02, f[1:]])

    monkeypatch.setattr(SlotPool, "_forward", forward)
    res, checks = _run()
    assert not res["correct"], checks


def _drop_top_degree(monkeypatch):
    """A Selfmix chain at fault on every route: its product loses its top
    output degree (l = Lout zeroed), as a kernel that skips one degree's
    rows would give."""
    from repro_torch.core.engine import ChainPlan

    sound = ChainPlan.apply

    def apply(self, *a, **kw):
        y = sound(self, *a, **kw)
        return torch.cat([y[..., : self.Lout ** 2], torch.zeros_like(y[..., self.Lout ** 2:])],
                         -1)

    monkeypatch.setattr(ChainPlan, "apply", apply)


def test_cell_broken_selfmix_chain_is_not_correct(tiny_cell, monkeypatch):
    _drop_top_degree(monkeypatch)
    res, checks = _run()
    print(f"broken Selfmix chain: {checks}")
    assert not res["correct"], checks


@pytest.mark.cuda
def test_broken_selfmix_chain_fails_the_limits(card, monkeypatch):
    """On the card, at the published widths, on whichever route the chain
    takes: a Selfmix chain that loses its top output degree fails the
    cell's limits on eight slab systems of 78 atoms."""
    from perfbench import check

    cfg, lim = bench.config("equiformer_v2_gaunt"), bench.limits(CELL)
    wts = fam.make_weights(cfg, 5, card)
    sp, pos = fam.molecules({}, 78, 8, 5)
    recs = [{"species": sp[i], "pos": pos[i]} for i in range(8)]
    ref = check.reference_serve(fam, cfg, wts, recs, torch.float64, card)
    model = fam.build(cfg, wts, card)
    _drop_top_degree(monkeypatch)
    with torch.no_grad():
        e, f = model.energy_forces(torch.as_tensor(sp, device=card),
                                   torch.as_tensor(pos, device=card))
    served = [{"species": sp[i], "energy": float(e[i]), "forces": f[i].double().cpu().numpy()}
              for i in range(8)]
    readings = check.serve_readings(served, ref)
    print(f"broken Selfmix chain: {readings} against the limits {lim}")
    assert not check.verdict(readings, lim), readings


@pytest.mark.cuda
def test_control_fails_the_limits(card):
    """On the card, at the published widths: the reference computed in
    float32 with TF32 products in the program's place fails the cell's
    limits on eight slab systems of 78 atoms."""
    from perfbench import check

    cfg, lim = bench.config("equiformer_v2_gaunt"), bench.limits(CELL)
    wts = fam.make_weights(cfg, 5, card)
    sp, pos = fam.molecules({}, 78, 8, 5)
    recs = [{"species": sp[i], "pos": pos[i]} for i in range(8)]
    readings = check.control_serve(fam, cfg, wts, recs, card)
    assert not check.verdict(readings, lim), readings
