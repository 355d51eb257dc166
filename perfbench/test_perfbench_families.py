"""Model families and run kinds found by name: the ``mace`` family gives the
same weights, inputs and reference as the harness gave before it moved
there (checksums pinned at CPU sizes); a configuration of a new family
enters as new files only (a family, a configuration, a traffic mix,
limits and a metric reader) and runs ``correct``; a missing family or
kind fails at once and names itself; and a walker stays near its first
geometry however many requests it sends."""
import hashlib
import json
import time

import numpy as np
import pytest
import torch

from perfbench import bench, run, serve
from perfbench.families import mace

SEED = 2 ** 32 + 11


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _clients(traffic, **sizes):
    mix = dict(bench.traffic(traffic), **sizes)
    return serve.make_clients(mace, mix, SEED)


# computed with the harness of the parent commit, before the family moved
@pytest.mark.parametrize("config", ["mace_escn", "mace_general"])
def test_mace_weights_pinned(tiny, config):
    wts = mace.make_weights(bench.config(config), SEED, "cpu")
    assert _digest([wts[k] for k in sorted(wts)]) == (
        "86a58da37e5a02fc4772e08aaa62fde3fd97b4119b4f27c4ecc4e1779983b72e")


@pytest.mark.parametrize("traffic,sizes,digest", [
    ("md_3bpa", dict(atoms=[6, 6], clients=8),
     "1cb917363e99aa63cb3974483cac3c07716e940dcf5b15f0e19d0d9f3cc0e334"),
    ("md_3bpa_s16", dict(atoms=[5, 8], clients=8),
     "f66dc55ebb169d3616fc910ea0fe331d01ea30b80f8136adc130069c930c57ae"),
], ids=["one_size", "mixed_sizes"])
def test_mace_clients_pinned(traffic, sizes, digest):
    cl = _clients(traffic, **sizes)
    assert _digest([c.species for c in cl] + [c.pos for c in cl]) == digest


@pytest.mark.parametrize("i,digest", [
    (0, "fd31c640ea0c34625b446c9b1bf9aad9af489339d8c1f556014678f951c5d8f9"),
    (5, "6cab2a5002d198f23f5a572f76cd9b93e134f5302a890afa2e6d824748055188"),
])
def test_mace_batches_pinned(i, digest):
    mix = dict(bench.traffic("train_3bpa"), atoms=6, batch=2, dataset=8)
    b = mace.batches(mix, SEED)(i)
    assert _digest([b[k] for k in sorted(b)]) == digest


def test_mace_reference_pinned(tiny):
    cfg = bench.config("mace_escn")
    ref = mace.reference(cfg, mace.make_weights(cfg, SEED, "cpu"), torch.float64, "cpu")
    c = _clients("md_3bpa", atoms=[6, 6], clients=8)[0]
    e = ref.energy(torch.as_tensor(c.species)[None],
                   torch.as_tensor(c.pos, dtype=torch.float64)[None])
    assert float(e[0]) == pytest.approx(-0.763197857988761, rel=1e-12, abs=0)


def test_mace_kernel_bounds_by_hand():
    """Each bucket's replays times its chain launches a replay, each call
    at the chain's least time on the bucket's rows; other kernels'
    launches are not the chain's."""
    from perfbench import work

    cfg = {"model": {"channels": 4, "L": 2, "nu": 3}}
    buckets = [{"n_slots": 2, "max_atoms": 8, "replays": 3,
                "launches": {"gaunt_chain": 2, "direct_conv": 2}},
               {"n_slots": 4, "max_atoms": 6, "replays": 0, "launches": {"gaunt_chain": 2}}]
    got = mace.kernel_bounds(cfg, buckets)["gaunt_chain"]
    f, b = work.chain_work(2 * 8 * 4, 2, 3, 2, gated=True)
    assert got["launches"] == 6
    assert got["bound_s"] == pytest.approx(6 * work.bound_s(f, b), rel=1e-15)
    roof = bench.metric_reader("gaunt_chain_roofline")
    rec = {"trace": {"op_s": {"gaunt_chain_kernel<3>": 2 * got["bound_s"], "other": 1.0}},
           "kernels": {"gaunt_chain": got}}
    assert roof(rec) == pytest.approx(50.0)
    assert roof(dict(rec, kernels={})) is None


def test_walk_stays_near_the_first_geometry():
    """After 500 requests every coordinate lies within 6 sigma of the
    walker's first geometry: each request is drawn around it anew."""
    mix = dict(bench.traffic("md_3bpa_s16"), clients=2)
    disp = mix["displacement"]
    for c in serve.make_clients(mace, mix, SEED):
        pos0 = c.pos.copy()
        reqs = [c.next_request(disp) for _ in range(500)]
        dev = np.abs(np.stack([r.pos for r in reqs]) - pos0)
        assert dev.max() < 6 * disp
        assert dev.std() > 0.5 * disp                 # each request is displaced
        np.testing.assert_array_equal(c.pos, pos0)


# ------------------------------------------------- a new family, files only
TOY_FAMILY = '''"""A family of the test: the MACE force field on molecules of its own,
atoms on a jittered line."""
import numpy as np

from perfbench.families import mace

make_weights, build, reference = mace.make_weights, mace.build, mace.reference


def molecules(mix, n_atoms, count, seed):
    rng = np.random.default_rng([seed, 11, n_atoms])
    line = np.arange(n_atoms)[:, None] * np.array([1.2, 0.3, 0.1])
    pos = line[None] + rng.normal(0.0, 0.05, (count, n_atoms, 3))
    species = rng.integers(0, mix["species"], (count, n_atoms))
    return species.astype(np.int64), pos.astype(np.float32)


def serve_flops(cfg, n_atoms):
    return n_atoms * (n_atoms - 1)


def kernel_bounds(cfg, buckets):
    return {}
'''

TOY_METRIC = '''"""toy_atoms_per_s: atoms of the evaluations completed in the window
over its seconds."""


def read(run):
    done = [r for r in run["records"] if r["t_done"] <= run["t_close"] and not r["failed"]]
    return sum(len(r["species"]) for r in done) / (run["t_close"] - run["t0"])
'''


def _write(root, rel, text):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _manifest(cell, config, traffic):
    e2e = [{"name": "evals_per_s", "unit": "evals/s", "better": "higher", "bound": 0.01,
            "source": "host_clock"},
           {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
            "source": "host_clock"}]
    per = [{"name": "toy_atoms_per_s", "unit": "atoms/s", "better": "higher",
            "source": "host_clock", "layer": "whole served step", "moves": "evals_per_s"}]
    return {"workloads": [{"name": cell, "config": config, "traffic": traffic, "chips": 1,
                           "why": "a test cell"}],
            "end_to_end": e2e, "per_layer": per}


@pytest.fixture
def new_root(tmp_path, monkeypatch):
    """A second search root before the package's own, holding a new
    family, its configuration, a traffic mix and the cell's limits."""
    cfg = bench.config("mace_escn")
    cfg.update(name="toy", family="toy",
               model=dict(cfg["model"], channels=4, hidden=8, chain_tune="heuristic"))
    _write(tmp_path, "configs/toy.json", json.dumps(cfg))
    _write(tmp_path, "traffic/toy_line.json", json.dumps(
        {"kind": "serve", "atoms": [5, 6], "species": 4, "clients": 4, "buckets": [[6, 2]],
         "displacement": 0.01, "trace_seconds": 1}))
    _write(tmp_path, "limits/toy.line.json", json.dumps({"energy_err": 2e-5, "force_err": 3e-4}))
    _write(tmp_path, "families/toy.py", TOY_FAMILY)
    monkeypatch.setattr(bench, "ROOTS", [tmp_path, bench.HERE])
    return tmp_path


def test_new_family_enters_as_files_only(new_root):
    _write(new_root, "metrics/toy_atoms_per_s.py", TOY_METRIC)
    man = _manifest("toy.line", "toy", "toy_line")
    res, checks, rec = run.run_cell("toy.line", SEED, 0.3, False, "cpu", time.perf_counter(),
                                    man)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert rec["family"].__file__ == str(new_root / "families" / "toy.py")
    e2e = run.read_metrics("toy.line", False, rec, man)
    assert set(e2e) == {"evals_per_s", "setup_s"}
    per = run.read_metrics("toy.line", True, rec, man)
    assert per["toy_atoms_per_s"]["value"] >= 5 * e2e["evals_per_s"]["value"] > 0


def test_missing_family_fails_and_names_it(new_root):
    cfg = json.loads((new_root / "configs" / "toy.json").read_text())
    _write(new_root, "configs/ghost.json", json.dumps(dict(cfg, name="ghost",
                                                           family="no_such_family")))
    _write(new_root, "limits/ghost.line.json", "{}")
    with pytest.raises(SystemExit, match="no_such_family"):
        run.run_cell("ghost.line", SEED, 0.3, False, "cpu", time.perf_counter(),
                     _manifest("ghost.line", "ghost", "toy_line"))


def test_missing_kind_fails_and_names_it(new_root):
    _write(new_root, "traffic/odd.json", json.dumps({"kind": "no_such_kind"}))
    _write(new_root, "limits/toy.odd.json", "{}")
    with pytest.raises(SystemExit, match="no_such_kind"):
        run.run_cell("toy.odd", SEED, 0.3, False, "cpu", time.perf_counter(),
                     _manifest("toy.odd", "toy", "odd"))
