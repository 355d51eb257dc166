"""The port's persistent autotune cache (`repro_torch.core.autotune_cache`)
against the reference's `tests/test_autotune_cache.py`: round trip and a
warm start with zero timing runs, lazy load with in-process entries
winning, calibration that does not pass a default for a measurement, the
fallbacks (fingerprint mismatch, corrupt, missing, unwritable files),
stale entries dropped one by one (a key of another device type among
them), merging saves, the environment variable, measurements that never
ran and pinned picks never persisted, the CLI's ``--verify-warm``, and a
warm serve process that makes zero timing runs."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.core import autotune_cache as ac
from repro_torch.core import engine

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _no_env_cache(monkeypatch):
    monkeypatch.delenv(ac.ENV_VAR, raising=False)


def _measure_some(eng):
    """One pairwise plan key and one chain key, both measured on the CPU."""
    p = eng.plan(1, 1, 2, batch_hint=32, tune="measure", requires_grad=False, device="cpu")
    cp = eng.plan_chain((1, 1), 1, tune="measure", batch_hint=32, device="cpu")
    return p, cp


def _chain_key(rows=32, device="cpu"):
    return engine.GauntEngine.chain_measure_key((1, 1), 1, "float32", rows, None, False,
                                                device)


def test_roundtrip_warm_engine_zero_timing_runs(tmp_path):
    """A second engine pointed at the flushed cache answers every selection
    from the file: zero timing runs, identical picks and timings."""
    path = str(tmp_path / "cache.json")
    cold = engine.GauntEngine(cache_path=path)
    p, cp = _measure_some(cold)
    assert cold.timing_runs == 2
    assert os.path.exists(path)  # every measurement flushed

    warm = engine.GauntEngine(cache_path=path)
    p2, cp2 = _measure_some(warm)
    assert warm.timing_runs == 0
    assert (p2.backend, cp2.backend) == (p.backend, cp.backend)
    assert warm._measured == cold._measured
    assert warm._measured_t == pytest.approx(cold._measured_t)
    assert set(cold._measured_t) == set(cold._measured)


def test_plan_and_chain_keys_round_trip(tmp_path):
    path = str(tmp_path / "cache.json")
    pk = engine.PlanKey(2, 1, 3, "conv_filter", 64, "bfloat16",
                        (("geometry", "wigner"),), "cpu")
    ck = engine.GauntEngine.chain_measure_key((2, 2, 2), 2, "bfloat16", 5000, (0, 0, 0),
                                              True, "cpu")
    ac.save(path, {pk: "escn_aligned", ck: "tree"}, {pk: 1.5, ck: None})
    sel, tim, _ = ac.load(path)
    assert sel == {pk: "escn_aligned", ck: "tree"}
    assert tim == {pk: 1.5}
    assert ck == ((2, 2, 2), 2, "bfloat16", 8192, (0, 0, 0), True, "cpu")


def test_load_is_lazy_and_in_process_wins(tmp_path):
    """The cache loads at the first measure-mode miss (not at
    construction), and an in-process pick is never overwritten by the
    file's."""
    path = str(tmp_path / "cache.json")
    cold = engine.GauntEngine(cache_path=path)
    _measure_some(cold)

    warm = engine.GauntEngine(cache_path=path)
    assert not warm._cache_loaded and warm._measured == {}
    key = engine.PlanKey(1, 1, 2, "pairwise", 32, device="cpu")
    assert key in cold._measured
    local_pick = "fft" if cold._measured[key] != "fft" else "direct"
    warm._measured[key] = local_pick
    p = warm.plan(1, 1, 2, batch_hint=32, tune="measure", requires_grad=False, device="cpu")
    assert warm._cache_loaded
    assert warm._measured[key] == local_pick and p.backend == local_pick
    assert warm._measured[_chain_key()] == cold._measured[_chain_key()]


def test_cleared_engine_loads_the_cache_again(tmp_path):
    path = str(tmp_path / "cache.json")
    eng = engine.GauntEngine(cache_path=path)
    _, cp = _measure_some(eng)
    eng.clear()
    assert eng._measured == {} and eng._measured_t == {} and eng.timing_runs == 0
    _, cp2 = _measure_some(eng)
    assert eng.timing_runs == 0 and cp2.backend == cp.backend


def test_calibration_roundtrips_without_masquerading(tmp_path):
    """Persisted fused-cost factors apply on load, but only entries the file
    marks *_measured, and never over a locally measured value."""
    path = str(tmp_path / "cache.json")
    try:
        engine.set_calibration(fused_skinny=2.5, fused_skinny_measured=True)
        engine.GauntEngine(cache_path=path).flush_autotune_cache()
        engine.reset_calibration()
        assert engine.GauntEngine(cache_path=path).load_autotune_cache() == 0
        cal = engine.get_calibration()
        assert cal["fused_skinny_measured"] and cal["fused_skinny"] == 2.5
        assert not cal["fused_skinny:bfloat16_measured"]  # a default is not a measurement
        engine.reset_calibration()
        engine.set_calibration(fused_skinny=9.5, fused_skinny_measured=True)
        engine.GauntEngine(cache_path=path).load_autotune_cache()
        assert engine.get_calibration()["fused_skinny"] == 9.5
    finally:
        engine.reset_calibration()


# ---------------------------------------------------------------------------
# fallback paths: the cache must never break planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field,value", [("torch_version", "0.0.0-other-host"),
                                         ("device_name", "another card"),
                                         ("capability", [8, 0]),
                                         ("schema", 0)])
def test_fingerprint_mismatch_falls_back_to_measurement(tmp_path, field, value):
    path = str(tmp_path / "cache.json")
    _measure_some(engine.GauntEngine(cache_path=path))
    raw = json.load(open(path))
    raw["fingerprint"][field] = value
    json.dump(raw, open(path, "w"))
    assert ac.load(path) is None
    warm = engine.GauntEngine(cache_path=path)
    assert warm.load_autotune_cache() == 0
    warm.plan(1, 1, 2, batch_hint=32, tune="measure", requires_grad=False, device="cpu")
    assert warm.timing_runs == 1


@pytest.mark.parametrize("content", ["{truncated", "", "[1, 2, 3]", "null"])
def test_corrupt_cache_falls_back_without_error(tmp_path, content):
    path = str(tmp_path / "cache.json")
    with open(path, "w") as f:
        f.write(content)
    assert ac.load(path) is None
    eng = engine.GauntEngine(cache_path=path)
    eng.plan(1, 1, 2, batch_hint=32, tune="measure", requires_grad=False, device="cpu")
    assert eng.timing_runs == 1 and eng.cache_unusable
    assert ac.load(path) is not None  # the autoflush repaired the file
    fresh = engine.GauntEngine(cache_path=path)
    assert fresh.load_autotune_cache() == 1 and not fresh.cache_unusable


def test_missing_and_disabled_paths_are_noops(tmp_path):
    assert ac.load(str(tmp_path / "nope.json")) is None
    assert ac.load(None) is None
    eng = engine.GauntEngine()
    assert eng.cache_path() is None
    assert eng.load_autotune_cache() == 0
    assert eng.flush_autotune_cache() is None
    # a missing file is a cold start, not an unusable cache
    eng.set_autotune_cache(str(tmp_path / "nope.json"))
    assert eng.load_autotune_cache() == 0 and not eng.cache_unusable


def test_skip_makes_a_warm_file_measure_cold(tmp_path):
    """The serve engine's response to the ``autotune_cache_load`` fault:
    nothing is loaded, not even lazily at the next miss."""
    path = str(tmp_path / "cache.json")
    _measure_some(engine.GauntEngine(cache_path=path))
    eng = engine.GauntEngine(cache_path=path)
    eng.skip_autotune_cache()
    _measure_some(eng)
    assert eng.timing_runs == 2 and eng.cache_unusable


def test_stale_entries_dropped_individually(tmp_path):
    """Entries naming an unregistered backend, a non-chain flavour under a
    chain key, an unknown kind or dtype, or another device type than the
    fingerprint's are dropped on load; valid neighbours survive."""
    path = str(tmp_path / "cache.json")
    cold = engine.GauntEngine(cache_path=path)
    _measure_some(cold)
    n_valid = len(cold._measured)
    raw = json.load(open(path))
    other = "cpu" if ac.fingerprint()["device_type"] == "cuda" else "cuda"

    def plan(kind="pairwise", dtype="float32", backend="dense_einsum", device="cpu"):
        return {"key": {"type": "plan", "L1": 1, "L2": 1, "Lout": 2, "kind": kind,
                        "batch_hint": 8, "dtype": dtype, "extra": [], "device": device},
                "backend": backend, "t": 1.0}

    def chain(backend="tree", dtype="float32", device="cpu"):
        return {"key": {"type": "chain", "Ls": [1, 1], "Lout": 1, "dtype": dtype,
                        "batch_hint": 8, "share": [0, 1], "gate": False, "device": device},
                "backend": backend, "t": 1.0}

    raw["selections"] += [
        plan(backend="warp_drive"),           # unregistered backend
        plan(kind="sixbody"),                 # unknown kind
        plan(dtype="float16"),                # unknown storage dtype
        plan(device=other),                   # another device type
        chain(backend="packed"),              # not a chain flavour
        chain(dtype="auto"),                  # not a storage dtype
        chain(device=other),                  # another device type
        {"key": {"type": "mystery"}, "backend": "tree"},
        {"backend": "fft", "t": 1.0},         # no key at all
    ]
    json.dump(raw, open(path, "w"))
    loaded = ac.load(path)
    assert loaded is not None and len(loaded[0]) == n_valid


def test_save_merges_concurrent_same_fingerprint_entries(tmp_path):
    """Two processes flushing different keys to one file converge; the
    flushing process's own entry wins a collision."""
    path = str(tmp_path / "cache.json")
    ka = engine.PlanKey(1, 1, 2, "pairwise", 8, device="cpu")
    kb = _chain_key(8)
    ac.save(path, {ka: "fft"}, {ka: 1.0})
    ac.save(path, {kb: "tree"}, {kb: 2.0})  # a "concurrent" process
    sel, tim, _ = ac.load(path)
    assert sel == {ka: "fft", kb: "tree"} and tim == {ka: 1.0, kb: 2.0}
    ac.save(path, {ka: "dense_einsum"}, {ka: 0.5})
    sel, tim, _ = ac.load(path)
    assert sel[ka] == "dense_einsum" and tim[ka] == 0.5


def test_unwritable_cache_degrades_to_in_process(tmp_path, monkeypatch):
    eng = engine.GauntEngine(cache_path=str(tmp_path / "cache.json"))

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ac, "save", boom)
    p = eng.plan(1, 1, 2, batch_hint=32, tune="measure", requires_grad=False, device="cpu")
    assert p.backend and len(eng._measured) == 1  # planned and cached in process
    with pytest.raises(OSError):
        eng.flush_autotune_cache()  # only the explicit flush surfaces it


def test_env_var_activates_persistence(tmp_path, monkeypatch):
    path = str(tmp_path / "env_cache.json")
    monkeypatch.setenv(ac.ENV_VAR, path)
    assert ac.ENV_VAR == "REPRO_TORCH_AUTOTUNE_CACHE"  # not the reference's variable
    eng = engine.GauntEngine()
    eng.plan(1, 1, 2, batch_hint=32, tune="measure", requires_grad=False, device="cpu")
    assert ac.load(path) is not None


def test_measure_fallback_is_not_cached(tmp_path, monkeypatch):
    """When nothing was timed, select() answers by the cost model and pins
    nothing, in process or on disk."""
    path = str(tmp_path / "cache.json")
    eng = engine.GauntEngine(cache_path=path)
    key = engine.PlanKey(1, 1, 2, "pairwise", 16, device="cpu")
    monkeypatch.setattr(engine.GauntEngine, "_measure", lambda self, k, e: None)
    assert eng.select(key, tune="measure", requires_grad=False)
    assert eng._measured == {} and eng._measured_t == {} and not os.path.exists(path)
    monkeypatch.undo()
    eng.select(key, tune="measure", requires_grad=False)
    assert key in eng._measured and key in eng._measured_t and ac.load(path)[0]


def test_pinned_pick_is_not_persisted(tmp_path):
    """A pick pinned by `pinned_chain` is not a measurement: a flush inside
    the block persists the measured pick (or nothing), never the pin."""
    path = str(tmp_path / "cache.json")
    eng = engine.GauntEngine(cache_path=path)
    _, cp = _measure_some(eng)
    other = "tree" if cp.backend != "tree" else "fused_torch"
    with eng.pinned_chain(_chain_key(), other):
        eng.plan_chain((1, 1), 1, tune="measure", batch_hint=64, device="cpu")  # flushes
        with eng.pinned_chain(_chain_key(4096), "tree"):
            eng.flush_autotune_cache()
    sel, _, _ = ac.load(path)
    assert sel[_chain_key()] == cp.backend and _chain_key(4096) not in sel
    assert eng._measured[_chain_key()] == cp.backend


def test_cli_verify_warm(tmp_path, monkeypatch, capsys):
    """The CLI measures its grid into the file, and a second run with
    --verify-warm makes zero timing runs (exit 0); a run against another
    file fails the check (exit 2).  The grid covers the cost model's
    calibration per storage dtype, the 'auto' dtype family and the gate
    policies, so the warm run needs none of them timed.  The grid is cut to
    CPU size here; the calibration lands in a process-wide table, restored
    after."""
    monkeypatch.setattr(engine, "_CALIB", dict(engine._CALIB_DEFAULTS))
    monkeypatch.setattr(ac, "_PLAN_LS", (1,))
    monkeypatch.setattr(ac, "_CHAINS", (((1, 1), 1, 32),))
    path = str(tmp_path / "cli.json")
    argv = ["--cache", path, "--fast", "--device", "cpu", "--serve-rows", "32"]
    monkeypatch.setattr(engine, "_ENGINE", engine.GauntEngine())
    assert ac.main(argv) == 0
    cal = engine.get_calibration()
    assert cal["fused_skinny_measured"] and cal["fused_skinny:bfloat16_measured"]
    keys = list(engine.get_engine()._measured)
    assert any(isinstance(k, engine.PlanKey) and k.dtype == "auto" for k in keys)
    assert any(isinstance(k, tuple) and k[2] == "auto" and k[5] for k in keys)
    # the gate policy keys on the storage dtype ('auto' resolves first)
    assert {k[2] for k in keys if isinstance(k, tuple) and ("gate", "policy") in k[7:]} \
        == {"float32", "bfloat16"}
    monkeypatch.setattr(engine, "_CALIB", dict(engine._CALIB_DEFAULTS))
    monkeypatch.setattr(engine, "_ENGINE", engine.GauntEngine())
    assert ac.main(argv + ["--verify-warm"]) == 0
    assert "verify-warm OK: zero timing runs" in capsys.readouterr().out
    assert engine.get_calibration()["fused_skinny:bfloat16_measured"]
    monkeypatch.setattr(engine, "_ENGINE", engine.GauntEngine())
    argv[1] = str(tmp_path / "other.json")
    assert ac.main(argv + ["--verify-warm"]) == 2


# ---------------------------------------------------------------------------
# a warm serve process makes zero timing runs
# ---------------------------------------------------------------------------

_SERVE_CHILD = r"""
import dataclasses, json, os
import numpy as np
import torch
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine
from repro_torch.core import engine as ce

cfg = dataclasses.replace(gaunt_mace_ff, channels=4, n_layers=1, L=1, L_edge=1,
                          n_species=4, chain_tune="measure",
                          autotune_cache=os.environ["CACHE_PATH"])
model = MaceGaunt(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
eng = EquivariantServeEngine(model, n_slots=1, max_atoms=4, warmup=True)
rng = np.random.default_rng(0)
req = EquivariantRequest(species=rng.integers(0, 4, 3),
                         pos=(rng.normal(size=(3, 3)) * 1.5).astype(np.float32))
out = eng.run([req])[0]
assert out.done and not out.rejected
g = ce.get_engine()
g.flush_autotune_cache()
print("RUNS=" + str(g.timing_runs))
print("PICKS=" + json.dumps(sorted((repr(k), v) for k, v in g._measured.items())))
print("SERVE_OK")
"""


def _subprocess_env(cache_path: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["CACHE_PATH"] = cache_path
    env.pop(ac.ENV_VAR, None)
    return env


def run_twice(child: str, cache_path: str, ok: str) -> list[dict]:
    """Run ``child`` in two fresh processes against one cache file -> the
    KEY=value lines each printed."""
    out = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                           env=_subprocess_env(cache_path), timeout=600)
        assert ok in r.stdout, (r.stdout[-2000:], r.stderr[-2000:])
        out.append(dict(ln.split("=", 1) for ln in r.stdout.splitlines() if "=" in ln))
    return out


def test_warm_serve_process_performs_zero_timing_runs(tmp_path):
    """A second process pointed at the populated cache makes zero timing
    runs through serve warmup and the first step, and picks as the cold
    process did."""
    cold, warm = run_twice(_SERVE_CHILD, str(tmp_path / "serve_cache.json"), "SERVE_OK")
    assert int(cold["RUNS"]) > 0, "the cold process should have measured"
    assert int(warm["RUNS"]) == 0, f"warm process ran {warm['RUNS']} timing passes"
    assert warm["PICKS"] == cold["PICKS"]
