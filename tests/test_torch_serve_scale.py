"""The port's bucketed serving against the reference's
`tests/test_serve_scale.py`, and against the reference engine itself: one
mixed request stream (every bucket, priorities, an expired deadline, an
invalid and an oversized request) completes in the same order with the same
rejection reasons and the same numbers; bucket padding is inert; staged
inputs are reused only while they are current; admissions stage early in
the overlap window; per-bucket warmup seeds every key the step asks, so
serving measures nothing, and on a warm autotune cache measures nothing
itself; and the step body, the code each bucket's CUDA
graph captures, never copies between host and device."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.gaunt_ff import gaunt_mace_ff as ref_cfg
from repro.models.equivariant import MaceGaunt as RefMace
from repro.serve.engine import EquivariantRequest as RefRequest
from repro.serve.engine import EquivariantServeEngine as RefEngine
from repro.serve.scheduler import Scheduler as RefScheduler
from repro.testing import tol_for
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.core import engine as _engine
from repro_torch.models.convert import params_from_jax
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine
from repro_torch.serve.scheduler import REASON_DEADLINE, Scheduler

SMALL = dict(channels=8, n_layers=1, L=1, L_edge=1, n_species=4)


def _pair(**kw):
    """The reference model with its params, and the port's model with the
    same parameters converted."""
    ref = RefMace(dataclasses.replace(ref_cfg, **SMALL, **kw))
    params = ref.init(jax.random.PRNGKey(0))
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **SMALL, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return ref, params, model


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def small_model(models):
    return models[2]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _mol(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, n), (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)


def _direct(model, r):
    e, f = model.energy_forces(torch.as_tensor(r.species),
                               torch.as_tensor(np.asarray(r.pos, np.float32)))
    return float(e), f.numpy()


def _close(a, b, tol, scale):
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= tol * scale


# ------------------------------------------------------- the reference engine


def _stream(cls):
    """Sizes across all three buckets, three priorities, one request whose
    deadline lapses in the queue, one with a NaN position, one too large."""
    reqs = []
    for i, n in enumerate([2, 7, 4, 10, 3, 9, 5, 1, 8, 6]):
        sp, pos = _mol(n, seed=40 + i)
        reqs.append(cls(species=sp, pos=pos, rid=i, priority=(i * 7) % 3))
    sp, pos = _mol(3, seed=60)
    reqs.append(cls(species=sp, pos=pos, rid=10, priority=-1, deadline=0.5))
    sp, pos = _mol(4, seed=61)
    pos[2, 1] = np.nan
    reqs.append(cls(species=sp, pos=pos, rid=11))
    sp, pos = _mol(11, seed=62)
    reqs.append(cls(species=sp, pos=pos, rid=12, priority=1))
    return reqs


def test_mixed_stream_matches_reference_engine(models):
    """Same stream, same buckets, same fake clock: the same completion order,
    the same rejections, energies within the f32 identity tier and forces
    within the loose tier of the reference engine."""
    ref, params, model = models
    buckets = [(3, 2), (6, 2), (10, 2)]
    out = {}
    for name, eng_cls, sched_cls, req_cls, args in (
            ("ref", RefEngine, RefScheduler, RefRequest, (ref, params)),
            ("port", EquivariantServeEngine, Scheduler, EquivariantRequest, (model,))):
        clock = FakeClock()
        eng = eng_cls(*args, buckets=buckets, clock=clock)
        sched = sched_cls(eng, clock=clock)
        reqs = _stream(req_cls)
        for r in reqs:
            sched.submit(r)
        clock.t = 1.0                      # rid 10's queue wait passes its deadline
        sched.drain()
        out[name] = (list(eng.metrics.completed_order), reqs,
                     [p.steps_run for p in eng.pools])
    (order_r, reqs_r, steps_r), (order_p, reqs_p, steps_p) = out["ref"], out["port"]
    assert order_p == order_r and steps_p == steps_r
    assert len(order_p) == 10
    assert [r.reject_reason for r in reqs_p] == [r.reject_reason for r in reqs_r]
    assert reqs_p[10].reject_reason.startswith(REASON_DEADLINE)
    assert reqs_p[11].reject_reason == "invalid:non-finite positions"
    assert reqs_p[12].reject_reason.startswith("too_large")
    for a, b in zip(reqs_p[:10], reqs_r[:10]):
        assert abs(a.energy - b.energy) <= tol_for("float32") * max(1.0, abs(b.energy))
        _close(a.forces, b.forces, tol_for("float32", "loose"), np.abs(b.forces).max())


def test_bucketed_mixed_workload_matches_direct(small_model):
    """Mixed sizes across two buckets complete with the energies and forces
    of unpadded direct evaluation: padding is inert in every bucket."""
    eng = EquivariantServeEngine(small_model, buckets=[(4, 2), (10, 2)])
    reqs = [EquivariantRequest(*_mol(n, seed=i), rid=i)
            for i, n in enumerate([2, 3, 4, 5, 7, 10, 3, 8])]
    out = eng.run(reqs)
    assert all(r.done and not r.rejected for r in out)
    for r in out:
        e, f = _direct(small_model, r)
        assert abs(r.energy - e) <= tol_for("float32") * max(1.0, abs(e)), r.rid
        _close(r.forces, f, tol_for("float32"), np.abs(f).max())
    assert all(p.steps_run > 0 for p in eng.pools)
    s = eng.metrics.summary()
    assert s["completed"] == len(reqs)
    assert 0.0 < s["padding_efficiency"] <= 1.0
    assert s["latency_p50_ms"] <= s["latency_p99_ms"]


def test_bucketed_equals_single_bucket_results(small_model):
    """The ladder changes padding and scheduling, never numbers."""
    def serve(buckets):
        reqs = [EquivariantRequest(*_mol(n, seed=i), rid=i)
                for i, n in enumerate([2, 5, 9, 3, 7])]
        EquivariantServeEngine(small_model, n_slots=2, max_atoms=9, buckets=buckets).run(reqs)
        return reqs

    for a, b in zip(serve(None), serve([(3, 2), (6, 2), (9, 2)])):
        np.testing.assert_allclose(a.energy, b.energy, rtol=1e-5)
        np.testing.assert_allclose(a.forces, b.forces, rtol=1e-4, atol=1e-6)


def test_relaxation_across_buckets(small_model):
    """Multi-step relaxation inside a bucket: the staged inputs are copied
    again after each relaxation write, not reused stale."""
    eng = EquivariantServeEngine(small_model, buckets=[(4, 1), (8, 1)])
    sp, pos0 = _mol(4, 7)
    s = 1e5
    req = EquivariantRequest(species=sp, pos=pos0.copy(), steps=2, step_size=s)
    out = eng.run([req])[0]
    assert out.done
    _, f0 = _direct(small_model, EquivariantRequest(species=sp, pos=pos0))
    pos1 = pos0 + s * f0
    np.testing.assert_allclose(out.pos, pos1, rtol=1e-5, atol=1e-6)
    e1, _ = _direct(small_model, EquivariantRequest(species=sp, pos=pos1))
    assert abs(out.energy - e1) <= 1e-4 * max(1.0, abs(e1))


def test_repeated_eval_staged_reuse_is_not_stale(small_model):
    """steps > 1 at step_size 0 evaluates one geometry again: the staged
    inputs may be reused, and every step still gives the direct energy."""
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)])
    sp, pos = _mol(4, 13)
    req = EquivariantRequest(species=sp, pos=pos.copy(), steps=3, step_size=0.0)
    out = eng.run([req])[0]
    assert out.done
    e, _ = _direct(small_model, out)
    assert abs(out.energy - e) <= 1e-4 * max(1.0, abs(e))
    assert eng.pools.pools[0].steps_run == 3


def test_overlap_admission_stages_early(small_model):
    """A request arriving while another bucket's step is in flight is
    admitted and staged inside the overlap window (counted), and completes
    with the direct numbers."""
    eng = EquivariantServeEngine(small_model, buckets=[(4, 1), (8, 1)])
    sched = Scheduler(eng)
    big = EquivariantRequest(*_mol(8, seed=1), steps=2, rid=0)
    small = EquivariantRequest(*_mol(3, seed=2), rid=1)
    sched.submit(big)
    calls = {"n": 0}

    def poll():
        calls["n"] += 1
        if calls["n"] == 2:            # inside the first step's overlap window
            sched.submit(small)

    while sched.pump(poll=poll):
        pass
    assert big.done and small.done
    assert eng.metrics.counters["staged_early"] >= 1
    e, _ = _direct(small_model, small)
    assert abs(small.energy - e) <= 1e-4 * max(1.0, abs(e))


def test_deadline_holds_in_real_engine(small_model):
    clock = FakeClock()
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)], clock=clock)
    sched = Scheduler(eng, clock=clock)
    live = EquivariantRequest(*_mol(3, seed=3), rid=0)
    stale = EquivariantRequest(*_mol(3, seed=4), rid=1, deadline=0.5)
    sched.submit(live)
    sched.submit(stale)
    clock.t = 1.0
    sched.drain()
    assert live.done and not live.rejected and live.energy is not None
    assert stale.rejected and stale.energy is None
    assert stale.reject_reason.startswith(REASON_DEADLINE)


def test_cfg_serve_buckets_knob(small_model):
    """serve_buckets sets the ladder when the engine gets no buckets
    argument; the argument wins over the config."""
    model2 = MaceGaunt(dataclasses.replace(small_model.cfg, serve_buckets=((4, 1), (8, 2))),
                       device="cpu")
    model2.load_state_dict(small_model.state_dict())
    eng = EquivariantServeEngine(model2)
    assert [p.spec.max_atoms for p in eng.pools] == [4, 8]
    assert eng.n_slots == 3
    eng2 = EquivariantServeEngine(model2, buckets=[(16, 1)])
    assert [p.spec.max_atoms for p in eng2.pools] == [16]
    assert [p.spec.max_atoms for p in EquivariantServeEngine(small_model, max_atoms=5).pools] \
        == [5]


# ------------------------------------------------------------- per-bucket warmup


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_per_bucket_warmup_seeds_every_key(compute_dtype):
    """Warmup measures each bucket's chain key at that bucket's row count
    (n_slots x max_atoms x channels: all slots in one pass), at float32 and
    at the storage dtype, gated and ungated, as the reference does; then
    serving both buckets performs no timing run."""
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **SMALL, chain_tune="measure",
                                          grid_gate="on", compute_dtype=compute_dtype),
                      device="cpu", generator=torch.Generator().manual_seed(0))
    ge = _engine.get_engine()
    ge.clear()
    buckets = [(4, 2), (16, 2)]
    eng = EquivariantServeEngine(model, buckets=buckets, warmup=True)
    c = model.cfg
    want = {ge.chain_measure_key((c.L,) * c.nu, c.L, d, S * n * c.channels, (0,) * c.nu, g,
                                 "cpu")
            for n, S in buckets for d in {"float32", compute_dtype} for g in (False, True)}
    assert all(ge.measured_pick(k) is not None for k in want)
    assert len({k[3] for k in want}) == 2          # two distinct row buckets
    assert all(p.compiled() for p in eng.pools)
    runs = ge.timing_runs
    out = eng.run([EquivariantRequest(*_mol(n, seed=n), rid=n) for n in (3, 12)])
    assert all(r.done and not r.rejected for r in out)
    assert ge.timing_runs == runs and eng.metrics.summary()["engine_timing_runs"] == runs
    ge.clear()


# ------------------------------------------------- the body a CUDA graph captures


class _NoHostRoundTrip(TorchDispatchMode):
    """Raises on every op that, on the card, would copy between host and
    device or wait for the device: a tensor made from host data (a list
    index, ``torch.tensor``, ``new_tensor``, ``as_tensor`` of numpy), a read
    back (``item``, ``tolist``), or a data-dependent shape (a boolean index,
    ``nonzero``, ``masked_select``)."""

    HOST = {torch.ops.aten.lift_fresh.default, torch.ops.aten.lift_fresh_copy.default,
            torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
            torch.ops.aten.masked_select.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.HOST:
            raise AssertionError(f"{func} inside the step body")
        if func is torch.ops.aten.index.Tensor and any(
                i is not None and i.dtype in (torch.bool, torch.uint8) for i in args[1]):
            raise AssertionError("a boolean index inside the step body")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("backend,compute_dtype,grid_gate", [
    ("fused_torch", "float32", "on"), ("tree", "float32", "on"),
    ("fused_torch", "bfloat16", "on"), ("tree", "float32", "off")])
def test_step_body_makes_no_host_round_trip(backend, compute_dtype, grid_gate):
    """The CPU rehearsal of a capture: after one warm step (builds, constant
    uploads, chain picks), the step body — forward and backward, on either
    chain backend a bucket may pick — makes no tensor from host data, reads
    nothing back and sizes nothing by the data, each of which on the card is
    a blocking copy or a wait that a CUDA graph capture forbids.  It must
    still give the same numbers."""
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, channels=4, n_layers=2, L=2, L_edge=3,
                                          n_species=4, chain_tune="measure", grid_gate=grid_gate,
                                          compute_dtype=compute_dtype),
                      device="cpu", generator=torch.Generator().manual_seed(0))
    eng = EquivariantServeEngine(model, buckets=[(6, 2)], warmup=True)
    pool = eng.pools.pools[0]
    c, ge = model.cfg, _engine.get_engine()
    key = ge.chain_measure_key((c.L,) * c.nu, c.L, compute_dtype, 2 * 6 * c.channels,
                               (0,) * c.nu, grid_gate == "on", "cpu")
    assert ge.measured_pick(key) is not None
    for r in [EquivariantRequest(*_mol(n, seed=n), rid=n) for n in (4, 6)]:
        assert pool.admit(r)
    pool.stage()
    with ge.pinned_chain(key, backend):    # the pick under test, whatever was measured
        e0, f0 = pool.step_staged()
        with _NoHostRoundTrip():
            e1, f1 = pool._forward(*pool._inputs)
    assert torch.equal(e0, e1) and torch.equal(f0, f1)


@pytest.mark.parametrize("backend,fourier_resident", [("fused_torch", True), ("tree", False)])
def test_general_step_body_makes_no_host_round_trip(backend, fourier_resident):
    """The same capture rehearsal over the general convolution's step: the
    filter Y(r), its Fourier grid (once per geometry, or per layer without
    residency) and the direct 2D convolution make no tensor from host data,
    read nothing back and size nothing by the data; the served step equals
    a direct evaluation of each molecule."""
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, channels=4, n_layers=2, L=2, L_edge=3,
                                          n_species=4, chain_tune="measure", grid_gate="on",
                                          conv_impl="general",
                                          fourier_resident=fourier_resident),
                      device="cpu", generator=torch.Generator().manual_seed(0))
    eng = EquivariantServeEngine(model, buckets=[(6, 2)], warmup=True)
    pool = eng.pools.pools[0]
    c, ge = model.cfg, _engine.get_engine()
    key = ge.chain_measure_key((c.L,) * c.nu, c.L, "float32", 2 * 6 * c.channels,
                               (0,) * c.nu, True, "cpu")
    reqs = [EquivariantRequest(*_mol(n, seed=n), rid=n) for n in (4, 6)]
    for r in reqs:
        assert pool.admit(r)
    pool.stage()
    with ge.pinned_chain(key, backend):
        e0, f0 = pool.step_staged()
        with _NoHostRoundTrip():
            e1, f1 = pool._forward(*pool._inputs)
        assert torch.equal(e0, e1) and torch.equal(f0, f1)
        for i, r in enumerate(reqs):
            n = len(r.species)
            e, f = model.energy_forces(torch.as_tensor(r.species), torch.as_tensor(r.pos))
            assert abs(float(e) - float(e0[i])) <= 3e-4 * max(1.0, abs(float(e)))
            assert float((f - f0[i, :n]).abs().max()) <= 2e-3 * max(1e-30, float(f.abs().max()))


_BUCKETED_CHILD = r"""
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
# two buckets whose quantized chain rows differ (4*4=16 vs 12*4=48 rows), so
# per-bucket warmup seeds two distinct measured chain keys
eng = EquivariantServeEngine(model, buckets=[(4, 1), (12, 1)], warmup=True)
rng = np.random.default_rng(0)
reqs = [EquivariantRequest(species=rng.integers(0, 4, n),
                           pos=(rng.normal(size=(n, 3)) * 1.5).astype(np.float32), rid=i)
        for i, n in enumerate([3, 10])]          # one per bucket
out = eng.run(reqs)
assert all(r.done and not r.rejected for r in out)
assert all(p.steps_run > 0 for p in eng.pools)
g = ce.get_engine()
g.flush_autotune_cache()
print("RUNS=" + str(g.timing_runs))
print("PICKS=" + json.dumps(sorted((repr(k), repr(v)) for k, v in g._measured.items())))
print("NKEYS=" + str(len(g._measured)))
print("SERVE_OK")
"""


def test_per_bucket_warmup_zero_timing_runs_on_warm_cache(tmp_path):
    """A second process pointed at the populated autotune cache makes zero
    timing runs through the bucketed warmup (every bucket's chain keys
    answered from disk) and both buckets' first steps, and picks as the
    cold process did."""
    from test_torch_autotune_cache import run_twice

    cold, warm = run_twice(_BUCKETED_CHILD, str(tmp_path / "bucketed_cache.json"),
                           "SERVE_OK")
    assert int(cold["RUNS"]) > 0, "the cold process should have measured"
    assert int(cold["NKEYS"]) >= 2, "per-bucket warmup should seed several keys"
    assert int(warm["RUNS"]) == 0, f"warm process ran {warm['RUNS']} timing passes"
    assert warm["PICKS"] == cold["PICKS"]
