"""The port's measured policies and the chain hints: ``dtype='auto'`` for
plans and chains, `GauntEngine.select_gate` and ``grid_gate='auto'``, the
``looped`` chain backend against ``tree`` and the reference's looped
chain, the all-SH measure keys left as they were, and the autotune cache
carrying the new key types while a file written before them loads warm.

On the CPU the measured candidates are the plain backends; what is held
here is the policy's plumbing (keys, caching, persistence, the resolved
model), not which candidate is faster.  Numerics: the f32 identity tier,
``repro.testing.tol_for('float32')``."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.testing import assert_close, random_array, random_irreps
from repro_torch.configs.gaunt_ff import EquivariantConfig, gaunt_mace_ff
from repro_torch.core import autotune_cache as ac
from repro_torch.core import engine
from repro_torch.core.rep import Rep, conversion_stats
from repro_torch.models.equivariant import (MaceGaunt, SegnnNBody, SelfmixLayer,
                                            _resolve_grid_gate)
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine

SMALL = dict(channels=4, n_layers=1, L=2, L_edge=3, n_species=4)


def _gate(C, seed):
    rng = np.random.default_rng(seed)
    return {"w1": torch.as_tensor(rng.normal(size=(C, 16)).astype(np.float32) * 0.3),
            "w2": torch.as_tensor(rng.normal(size=(16, C)).astype(np.float32) * 0.3)}


def _margin_pick(eng, key, default):
    """What `_resolve_auto` keeps from the timings it recorded: the other
    candidate only where its median is below the default's fastest call."""
    times, spread = eng.measured_times[key], eng.measured_spread[key]
    other = next(k for k in times if k != default)
    return other if times[other] < spread[default][0] else default


# --------------------------------------------------------------------------
# dtype='auto'
# --------------------------------------------------------------------------


def test_plan_auto_dtype_measures_both_siblings():
    eng = engine.GauntEngine()
    p = eng.plan(2, 2, 2, dtype="auto", tune="measure", batch_hint=64, requires_grad=False,
                 device="cpu")
    f32 = engine.PlanKey(2, 2, 2, "pairwise", 64, "float32", (), "cpu")
    bf16 = dataclasses.replace(f32, dtype="bfloat16")
    auto = dataclasses.replace(f32, dtype="auto")
    assert eng.measured_pick(f32) and eng.measured_pick(bf16)  # each sibling's backend
    want = _margin_pick(eng, auto, "float32")
    assert p.key.dtype == eng.measured_pick(auto) == want
    runs = eng.timing_runs
    assert runs == 3  # one measurement per storage sibling, one of the two picks
    assert eng.plan(2, 2, 2, dtype="auto", tune="measure", batch_hint=64,
                    requires_grad=False, device="cpu").key.dtype == want
    assert eng.timing_runs == runs  # the 'auto' pick is cached


def test_chain_auto_dtype_measures_both_siblings():
    eng = engine.GauntEngine()
    cp = eng.plan_chain((2, 2, 2), 2, dtype="auto", tune="measure", batch_hint=64,
                        share_hint=(0, 0, 0), device="cpu")
    keys = {d: eng.chain_measure_key((2, 2, 2), 2, d, 64, (0, 0, 0), False, "cpu")
            for d in ("float32", "bfloat16", "auto")}
    assert eng.measured_pick(keys["float32"]) and eng.measured_pick(keys["bfloat16"])
    assert cp.dtype == eng.measured_pick(keys["auto"]) == \
        _margin_pick(eng, keys["auto"], "float32")
    assert eng.timing_runs == 3
    # heuristic tuning never times: float32
    assert engine.GauntEngine().plan_chain((2, 2), 2, dtype="auto", device="cpu").dtype == \
        "float32"


# --------------------------------------------------------------------------
# the gate policy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("out_hint", ["sh", "fourier"])
def test_select_gate_times_both_and_caches(out_hint):
    eng = engine.GauntEngine()
    Lout = 2 if out_hint == "sh" else 6
    pick = eng.select_gate((2, 2, 2), Lout, batch_hint=64, share_hint=(0, 0, 0),
                           out_hint=out_hint, device="cpu")
    key = eng.chain_measure_key((2, 2, 2), Lout, "float32", 64, (0, 0, 0), False, "cpu",
                                None, out_hint) + (("gate", "policy"),)
    assert set(eng.measured_times[key]) == {"grid", "sh"}
    assert pick == _margin_pick(eng, key, "sh") == eng.measured_pick(key)
    runs = eng.timing_runs
    assert eng.select_gate((2, 2, 2), Lout, batch_hint=60, share_hint=(0, 0, 0),
                           out_hint=out_hint, device="cpu") == pick
    assert eng.timing_runs == runs
    assert engine.GauntEngine().select_gate((2, 2, 2), 2, tune="heuristic",
                                            device="cpu") == "sh"


def test_grid_gate_auto_resolves_through_the_policy():
    """MaceGaunt with grid_gate='auto' and chain_tune='measure' runs the
    parameterization the measured policy picked at its rows: equal to the
    model with that grid_gate pinned.  SEGNN's 'auto' stays off."""
    cfg = dataclasses.replace(gaunt_mace_ff, **SMALL, chain_tune="measure", grid_gate="auto")
    model = MaceGaunt(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    sp = torch.as_tensor(rng.integers(0, 4, (2, 5)))
    pos = torch.as_tensor(rng.normal(size=(2, 5, 3)).astype(np.float32) * 1.5)
    feat = model.features(sp, pos)
    eng = engine.get_engine()
    key = eng.chain_measure_key((2, 2, 2), 2, "float32", 2 * 5 * 4, (0, 0, 0), False,
                                "cpu") + (("gate", "policy"),)
    pick = eng.measured_pick(key)
    assert pick in ("grid", "sh")
    assert _resolve_grid_gate(cfg, (2, 2, 2), 2, 40, (0, 0, 0), "cpu") == (pick == "grid")
    pinned = MaceGaunt(dataclasses.replace(cfg, grid_gate="on" if pick == "grid" else "off"),
                       device="cpu")
    pinned.load_state_dict(model.state_dict())
    assert_close(feat.detach().numpy(), pinned.features(sp, pos).detach().numpy(),
                 dtype="float32")
    heur = dataclasses.replace(cfg, chain_tune="heuristic")
    assert _resolve_grid_gate(heur, (2, 2, 2), 2, 40, (0, 0, 0), "cpu") is False
    # SEGNN's gate has no chain to fuse into: 'auto' is its SH gate
    kw = dict(name="t", kind="segnn", L=1, L_edge=1, channels=4, n_layers=1,
              chain_tune="measure")
    seg = SegnnNBody(EquivariantConfig(**kw, grid_gate="auto"), device="cpu")
    off = SegnnNBody(EquivariantConfig(**kw), device="cpu")
    off.load_state_dict(seg.state_dict())
    q, p, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in
               ((4,), (4, 3), (4, 3)))
    with conversion_stats(fresh=True) as c:
        got = seg(q, p, v)
    assert c["sh_to_quad"] == 0
    assert_close(got.detach().numpy(), off(q, p, v).detach().numpy(), dtype="float32")


def test_served_grid_gate_auto_equals_direct():
    """Serve warmup resolves grid_gate='auto' once for the model before
    building the step; served energies and forces equal direct evaluation
    even where the policy at a single molecule's rows picks the other way
    (the grid gate is a parameterization: one per model)."""
    cfg = dataclasses.replace(gaunt_mace_ff, **SMALL, chain_tune="measure", grid_gate="auto")
    model = MaceGaunt(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    eng = EquivariantServeEngine(model, n_slots=2, max_atoms=6, warmup=True)
    ge = engine.get_engine()

    def key(rows):
        return ge.chain_measure_key((2, 2, 2), 2, "float32", rows, (0, 0, 0), False,
                                    "cpu") + (("gate", "policy"),)

    pick = ge.measured_pick(key(2 * 6 * 4))
    assert model.grid_gate_on(4, "cpu") == (pick == "grid")
    for n in (4, 6):  # the direct evaluations' keys pick the other way
        ge._measured[key(n * 4)] = "sh" if pick == "grid" else "grid"
    rng = np.random.default_rng(4)
    reqs = [EquivariantRequest(rng.integers(0, 4, n),
                               (rng.normal(size=(n, 3)) * 1.5).astype(np.float32), rid=i)
            for i, n in enumerate((4, 6))]
    for r in eng.run(reqs):
        e, f = model.energy_forces(torch.as_tensor(r.species), torch.as_tensor(r.pos))
        assert_close(np.float32(r.energy), e.numpy(), dtype="float32")
        assert_close(np.asarray(r.forces), f.numpy(), dtype="float32")


@pytest.mark.parametrize("default,other,want", [
    ("float32", ([2.0] * 10 + [3.0] * 10, [2.1] * 20), "float32"),   # inside f32's spread
    ("float32", ([2.0] * 20, [1.5] * 20), "bfloat16"),              # past it
    ("sh", ([1.0, 2.0, 2.0], [1.5] * 3), "sh"),
    ("sh", ([1.0, 2.0, 2.0], [0.5] * 3), "grid"),
])
def test_auto_policy_switches_only_past_the_default_spread(monkeypatch, default, other, want):
    """`_resolve_auto` keeps the default (f32, 'sh') unless the other
    candidate's median is below the default's fastest call; the decision
    is cached, and heuristic tuning resolves to the default untimed."""
    name = "bfloat16" if default == "float32" else "grid"
    series = {default: other[0], name: other[1]}
    eng = engine.GauntEngine()
    monkeypatch.setattr(engine, "_time_calls", lambda fn, device: series[fn()])
    key = ("test", default)
    cands = {k: (lambda k=k: (lambda: k)) for k in (default, name)}
    assert eng._resolve_auto(key, "measure", torch.device("cpu"), default, cands) == want
    assert eng.measured_pick(key) == want and eng.timing_runs == 1
    assert eng._resolve_auto(key, "measure", torch.device("cpu"), default, {}) == want
    assert eng.timing_runs == 1
    assert engine.GauntEngine()._resolve_auto(("other",), "heuristic", torch.device("cpu"),
                                              default, cands) == default


def _auto_models():
    """(name, a builder of the model with every 'auto' option on, its call
    on a fixed small input, its stored decisions)."""
    rng = np.random.default_rng(11)
    sp = torch.as_tensor(rng.integers(0, 4, (2, 5)))
    pos = torch.as_tensor(rng.normal(size=(2, 5, 3)).astype(np.float32) * 1.5)
    q, p, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((2, 4), (2, 4, 3), (2, 4, 3)))
    x = torch.as_tensor(rng.normal(size=(6, 4, 9)).astype(np.float32))
    mace = dataclasses.replace(gaunt_mace_ff, **SMALL, chain_tune="measure", grid_gate="auto",
                               compute_dtype="auto")
    seg = EquivariantConfig(name="t", kind="segnn", L=1, L_edge=1, channels=4, n_layers=1,
                            chain_tune="measure", compute_dtype="auto")
    return {
        "mace": (lambda: MaceGaunt(mace, device="cpu"),
                 lambda m: m.features(sp, pos),
                 lambda m: (m.grid_gate_on(7, "cpu"), m.storage_dtype(7, "cpu"))),
        "segnn": (lambda: SegnnNBody(seg, device="cpu"),
                  lambda m: m(q, p, v),
                  lambda m: m.storage_dtype(7, "cpu")),
        "selfmix": (lambda: SelfmixLayer(2, 4, tune="measure", compute_dtype="auto",
                                         device="cpu"),
                    lambda m: m(x),
                    lambda m: m.storage_dtype(x[:1])),
    }


@pytest.mark.parametrize("name", ["mace", "segnn", "selfmix"])
def test_auto_picks_are_kept_in_the_model_state(name, tmp_path):
    """A model's 'auto' grid gate and storage dtype are resolved once and
    stored in its state: a model loaded from a saved state_dict (and one
    restored from a checkpoint) keeps them, asked at other rows, with zero
    timing runs, even after the engine's measurements are gone, and
    computes the same output; a state without them (the reference's
    converted parameters) still loads."""
    from repro_torch.checkpoint.manager import CheckpointManager

    build, call, picks = _auto_models()[name]
    eng = engine.get_engine()
    eng.clear()
    model = build()
    with torch.no_grad():
        want = call(model)
    stored = picks(model)
    torch.save(model.state_dict(), tmp_path / "model.pt")
    eng.clear()  # nothing measured is left to answer from
    again = build()
    again.load_state_dict(torch.load(tmp_path / "model.pt"))
    assert picks(again) == stored and eng.timing_runs == 0
    with torch.no_grad():
        assert_close(call(again).numpy(), want.numpy(), dtype="float32")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"model": model.state_dict()})
    mgr.wait()
    restored = build()
    tree, _ = mgr.restore(1, {"model": restored.state_dict()}, device="cpu")
    restored.load_state_dict(tree["model"])
    runs = eng.timing_runs  # the call above measured chain backends, not the picks
    assert picks(restored) == stored and eng.timing_runs == runs
    plain = {k: v for k, v in model.state_dict().items() if not k.endswith("_pick")}
    build().load_state_dict(plain)


# --------------------------------------------------------------------------
# the looped chain backend
# --------------------------------------------------------------------------


@pytest.mark.parametrize("gated", [False, True])
def test_looped_equals_tree_and_reference(gated):
    """The looped fold computes the tree's product: weights, output weights,
    a resident operand and the gate included; and the reference's looped
    chain on the same inputs."""
    L = 2
    x = random_irreps(L, (3, 4), seed=1)
    y = random_irreps(L, (3, 4), seed=2)
    ws = [random_array((3, 4, L + 1), seed=3 + i) for i in range(3)]
    wo = random_array((L + 1,), seed=9)
    gp = _gate(4, 10) if gated else None
    kw = {"gate_params": gp} if gated else {}
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    wt = [torch.as_tensor(w) for w in ws]
    outs = {}
    for b in ("tree", "looped"):
        cp = engine.plan_chain((L, L, L), L, backend=b, gate=gated)
        outs[b] = cp.apply([xt, yt, xt], weights=wt, w_out=torch.as_tensor(wo), **kw)
    assert_close(outs["looped"].numpy(), outs["tree"].numpy(), dtype="float32")
    ref = ref_engine.plan_chain((L, L, L), L, backend="looped", gate=gated)
    rkw = {"gate_params": {k: jnp.asarray(v.numpy()) for k, v in gp.items()}} if gated else {}
    want = ref.apply([jnp.asarray(x), jnp.asarray(y), jnp.asarray(x)],
                     weights=[jnp.asarray(w) for w in ws], w_out=jnp.asarray(wo), **rkw)
    assert_close(outs["looped"].numpy(), np.asarray(want), dtype="float32")
    res = Rep.from_sh(yt, L).to_fourier("half")
    cp = engine.plan_chain((L, L, L), L, backend="looped", gate=gated)
    got = cp.apply([xt, res, xt], weights=[wt[0], None, wt[2]], w_out=torch.as_tensor(wo), **kw)
    tree = engine.plan_chain((L, L, L), L, backend="tree", gate=gated)
    assert_close(got.numpy(), tree.apply([xt, res, xt], weights=[wt[0], None, wt[2]],
                                         w_out=torch.as_tensor(wo), **kw).numpy(),
                 dtype="float32")
    with pytest.raises(ValueError, match="resident exit"):
        engine.plan_chain((L, L), 2 * L, backend="looped").apply([xt, yt], out_basis="fourier")


def test_resident_exit_leaves_looped_out_of_the_measurement():
    eng = engine.GauntEngine()
    eng.plan_chain((1, 1), 2, tune="measure", batch_hint=32, out_hint="fourier", device="cpu")
    key = eng.chain_measure_key((1, 1), 2, "float32", 32, None, False, "cpu", None, "fourier")
    assert set(eng.measured_times[key]) == {"tree", "fused_torch"}
    eng.plan_chain((1, 1), 1, tune="measure", batch_hint=32, entry_hint=("sh", "fourier"),
                   device="cpu")
    key = eng.chain_measure_key((1, 1), 1, "float32", 32, None, False, "cpu",
                                ("sh", "fourier"), "sh")
    assert set(eng.measured_times[key]) == {"tree", "looped", "fused_torch"}
    with pytest.raises(ValueError, match="entry_hint"):
        eng.plan_chain((1, 1), 1, entry_hint=("sh",), device="cpu")
    with pytest.raises(ValueError, match="out_hint"):
        eng.plan_chain((1, 1), 1, out_hint="grid", device="cpu")


# --------------------------------------------------------------------------
# measure keys and the autotune cache
# --------------------------------------------------------------------------


def test_all_sh_measure_keys_unchanged():
    """Explicit all-'sh' hints give the same 7-tuple key as no hints: the
    serve engine's, the smoke test's and every persisted all-SH key stay
    as they were; only other bases extend the key."""
    base = engine.GauntEngine.chain_measure_key((2, 2, 2), 2, "float32", 8192, (0, 0, 0),
                                                True, "cuda")
    assert base == ((2, 2, 2), 2, "float32", 8192, (0, 0, 0), True, "cuda")
    assert engine.GauntEngine.chain_measure_key((2, 2, 2), 2, "float32", 8192, (0, 0, 0),
                                                True, "cuda", ("sh",) * 3, "sh") == base
    ext = engine.GauntEngine.chain_measure_key((1, 1), 1, "float32", 80000, None, False, "cuda",
                                               ("sh", "fourier"))
    assert ext[:7] == ((1, 1), 1, "float32", 16384, (0, 1), False, "cuda")
    assert ext[7:] == (("entries", ("sh", "fourier")), ("out", "sh"))


def test_cache_written_before_the_new_keys_loads_warm(tmp_path):
    """A file in the previous format (chain keys without "extra", no 'auto'
    or gate-policy entries) still loads, and its keys answer with zero
    timing runs."""
    path = str(tmp_path / "old.json")
    key = {"type": "chain", "Ls": [2, 2, 2], "Lout": 2, "dtype": "float32",
           "batch_hint": 64, "share": [0, 0, 0], "gate": True, "device": "cpu"}
    json.dump({"fingerprint": ac.fingerprint(),
               "selections": [{"key": key, "backend": "fused_torch", "t": 1e-3}],
               "calibration": engine.get_calibration()}, open(path, "w"))
    eng = engine.GauntEngine(cache_path=path)
    cp = eng.plan_chain((2, 2, 2), 2, tune="measure", batch_hint=64, share_hint=(0, 0, 0),
                        gate=True, device="cpu")
    assert cp.backend == "fused_torch" and eng.timing_runs == 0


def test_new_key_types_persist_and_reload_warm(tmp_path):
    """'auto' siblings, gate policies and non-SH chain keys round-trip
    through the cache file: a fresh engine repeats every pick with zero
    timing runs."""
    path = str(tmp_path / "cache.json")

    def run(eng):
        return (eng.plan(1, 1, 2, dtype="auto", tune="measure", batch_hint=32,
                         requires_grad=False, device="cpu").key.dtype,
                eng.plan_chain((1, 1), 2, dtype="auto", tune="measure", batch_hint=32,
                               device="cpu").dtype,
                eng.select_gate((1, 1, 1), 1, batch_hint=32, share_hint=(0, 0, 0), device="cpu"),
                eng.plan_chain((1, 1), 1, tune="measure", batch_hint=32,
                               entry_hint=("sh", "fourier"), device="cpu").backend)

    cold = engine.GauntEngine(cache_path=path)
    picks = run(cold)
    assert cold.timing_runs > 0
    warm = engine.GauntEngine(cache_path=path)
    assert run(warm) == picks and warm.timing_runs == 0
    raw = json.load(open(path))
    kinds = {(e["key"]["type"], e["key"]["dtype"], bool(e["key"].get("extra")))
             for e in raw["selections"]}
    assert ("plan", "auto", False) in kinds and ("chain", "auto", False) in kinds
    assert ("chain", "float32", True) in kinds
    # a stale policy value is dropped on its own
    for e in raw["selections"]:
        if ["gate", "policy"] in e["key"].get("extra", []):
            e["backend"] = "tree"
    json.dump(raw, open(path, "w"))
    sel = ac.load(path)[0]
    assert not any(("gate", "policy") in k[7:] for k in sel if isinstance(k, tuple))
