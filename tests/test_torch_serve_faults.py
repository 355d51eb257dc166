"""The port's fault-tolerant serving against the reference's
`tests/test_serve_faults.py`: deterministic fault injection (the same
schedule as the reference's for one seed), step-level recovery (idempotent
retries, structured rejection past the budget), non-finite quarantine that
spares bucket-mates, bisection of a batch that fails as a whole, the real
watchdog, warmup-time compile faults, the straggler cap, and replica
failover that keeps (priority, FIFO) order; an unreadable autotune cache
degrades to cold measurement, and failover on a warm cache makes no timing
run."""
import dataclasses
import json
import time

import jax
import numpy as np
import pytest

from repro.configs.gaunt_ff import gaunt_mace_ff as ref_cfg
from repro.models.equivariant import MaceGaunt as RefMace
from repro.serve import faults as ref_faults
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.core import engine as _engine
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.models.convert import params_from_jax
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine
from repro_torch.serve.faults import POINTS, FaultPlan, InjectedFault, fire, injected
from repro_torch.serve.replicas import ReplicaSet
from repro_torch.serve.scheduler import Scheduler

SMALL = dict(channels=8, n_layers=1, L=1, L_edge=1, n_species=4)


@pytest.fixture(scope="module")
def small_model():
    ref = RefMace(dataclasses.replace(ref_cfg, **SMALL))
    params = ref.init(jax.random.PRNGKey(0))
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **SMALL), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model


def _mol(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, n), (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)


def _reqs(n_req=6, steps=2, step_size=0.01, max_retries=8):
    return [EquivariantRequest(*_mol(3 + (i % 3), seed=i), rid=i, steps=steps,
                               step_size=step_size, max_retries=max_retries)
            for i in range(n_req)]


# ---------------------------------------------------------------------------
# FaultPlan determinism (no model needed)
# ---------------------------------------------------------------------------


def _drive(plan, fire_fn, inject, n=200):
    with inject(plan):
        for i in range(n):
            fire_fn("step_raise", tag=f"replica{i % 2}", n_active=3)
            fire_fn("step_nonfinite", n_active=3)
            fire_fn("step_timeout", n_active=1)
            fire_fn("compile_fail", pool="b4")
    return plan.schedule_keys(), [s.payload for s in plan.fired]


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_schedule_matches_reference(seed):
    """One seed realizes the same fault schedule, payloads included, in both
    packages: a chaos run replays across them."""
    kw = dict(seed=seed, rates={"step_raise": 0.1, "step_nonfinite": 0.15,
                                "step_timeout": 0.05},
              at={"compile_fail": (0, 3)}, max_fires=12,
              scope=lambda ctx: ctx.get("tag", "replica1") == "replica1")
    got = _drive(FaultPlan(**kw), fire, injected)
    want = _drive(ref_faults.FaultPlan(**kw), ref_faults.fire, ref_faults.injected)
    assert got == want and got[0]
    assert POINTS == ref_faults.POINTS
    for point in POINTS:
        assert [FaultPlan(**kw).would_fire(point, n) for n in range(300)] == \
            [ref_faults.FaultPlan(**kw).would_fire(point, n) for n in range(300)]


def test_same_seed_same_schedule():
    def drive(plan):
        with injected(plan):
            for _ in range(200):
                fire("step_raise", n_active=2)
                fire("step_nonfinite", n_active=2)
        return plan.schedule_keys(), [s.payload for s in plan.fired]

    rates = {"step_raise": 0.1, "step_nonfinite": 0.1}
    a = drive(FaultPlan(seed=7, rates=rates))
    assert a == drive(FaultPlan(seed=7, rates=rates)) and a[0]
    assert a[0] != drive(FaultPlan(seed=8, rates=rates))[0]


def test_point_streams_are_independent():
    """A point's schedule is a function of (seed, its own invocation index):
    traffic on other points does not shift it."""
    p1 = FaultPlan(seed=3, rates={"step_raise": 0.2})
    with injected(p1):
        for _ in range(100):
            fire("step_raise", n_active=1)
    p2 = FaultPlan(seed=3, rates={"step_raise": 0.2, "step_timeout": 0.5})
    with injected(p2):
        for _ in range(100):
            fire("step_timeout", n_active=1)
            fire("step_raise", n_active=1)
    assert p1.schedule_keys() == [k for k in p2.schedule_keys() if k[0] == "step_raise"]


def test_scope_gates_without_advancing_counter():
    scoped = FaultPlan(seed=5, at={"step_raise": (0, 2)},
                       scope=lambda ctx: ctx.get("tag") == "replica1")
    with injected(scoped):
        for i in range(6):
            fire("step_raise", tag=f"replica{i % 2}", n_active=1)
    assert scoped.schedule_keys() == [("step_raise", 0), ("step_raise", 2)]


def test_unknown_point_rejected():
    with pytest.raises(ValueError):
        FaultPlan(rates={"not_a_point": 1.0})
    with pytest.raises(ValueError):
        FaultPlan().check("not_a_point")


def test_no_plan_fire_is_noop():
    assert fire("step_raise", n_active=1) is None


# ---------------------------------------------------------------------------
# step-level recovery on the real engine
# ---------------------------------------------------------------------------


def test_faulted_results_match_fault_free(small_model):
    """Under injected raises, NaNs and timeouts every request completes, and
    every result (multi-step relaxations included) equals the fault-free
    run: retries restart from the admission snapshot."""
    base = EquivariantServeEngine(small_model, buckets=[(6, 2)]).run(_reqs())
    eng = EquivariantServeEngine(small_model, buckets=[(6, 2)])
    plan = FaultPlan(seed=1, rates={"step_raise": 0.15, "step_nonfinite": 0.15,
                                    "step_timeout": 0.1})
    with injected(plan):
        out = eng.run(_reqs())
    assert plan.fired and eng.metrics.counters["step_failures"] > 0
    for b, o in zip(base, out):
        assert o.done and not o.rejected, (o.rid, o.reject_reason)
        assert o.energy == b.energy, o.rid
        np.testing.assert_array_equal(o.forces, b.forces)
        np.testing.assert_array_equal(o.pos, b.pos)


def test_retry_exhaustion_rejects_structurally(small_model):
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)])
    req = _reqs(1, max_retries=2)[0]
    with injected(FaultPlan(seed=0, rates={"step_raise": 1.0})):
        out = eng.run([req])[0]
    assert out.done and out.rejected
    assert out.reject_reason == "step_failed:step_raised"
    assert out.energy is None and out.forces is None
    s = eng.metrics.summary()
    assert s["rejected:step_failed"] == 1
    assert s["retries"] == 2          # the budget, exactly
    assert s["step_failures"] == 3    # the first attempt and two retries


def test_quarantine_spares_bucket_mates(small_model):
    """A non-finite slot is quarantined alone: its bucket-mate retires in
    the same step with its fault-free energy."""
    base = EquivariantServeEngine(small_model, buckets=[(6, 2)]) \
        .run(_reqs(2, steps=1, step_size=0.0))
    eng = EquivariantServeEngine(small_model, buckets=[(6, 2)])
    plan = FaultPlan(seed=0, at={"step_nonfinite": (0,)},
                     payload={"step_nonfinite": {"slots": [0]}})
    with injected(plan):
        out = eng.run(_reqs(2, steps=1, step_size=0.0))
    assert all(o.done and not o.rejected for o in out)
    assert eng.metrics.counters["quarantined"] == 1
    assert out[1].energy == base[1].energy     # retired on the first step
    assert out[0].energy == base[0].energy     # retried to the same number
    assert eng.metrics.counters["retries"] == 1


def test_collective_nonfinite_bisects_to_retry(small_model):
    """slots='all' poisons the whole batch: the pool bisects, finds every
    slot finite on its own, and retries them all without quarantine."""
    eng = EquivariantServeEngine(small_model, buckets=[(6, 2)])
    plan = FaultPlan(seed=0, at={"step_nonfinite": (0,)},
                     payload={"step_nonfinite": {"slots": "all"}})
    with injected(plan):
        out = eng.run(_reqs(2, steps=1, step_size=0.0))
    assert all(o.done and not o.rejected for o in out)
    s = eng.metrics.summary()
    assert s["nonfinite_bisects"] == 1 and s["quarantined"] == 0
    assert s["step_failures:nonfinite_collective"] == 1
    base = EquivariantServeEngine(small_model, buckets=[(6, 2)]) \
        .run(_reqs(2, steps=1, step_size=0.0))
    assert [o.energy for o in out] == [b.energy for b in base]


def test_bisect_finds_the_degenerate_slot(small_model):
    """A slot whose own evaluation is non-finite is found by bisection: in
    the one-pass evaluation of all slots its NaN does not reach its
    bucket-mates, so the first masked evaluation already separates it (the
    sub-batch mask leaves the inputs stale, so the next step copies them
    again)."""
    eng = EquivariantServeEngine(small_model, buckets=[(6, 4)])
    pool = eng.pools.pools[0]
    reqs = _reqs(4, steps=1, step_size=0.0)
    for r in reqs:
        assert pool.admit(r)
    pool.pos[2, 0] = np.nan                  # slot 2 alone is degenerate
    pool.stage()
    assert pool._bisect_nonfinite([0, 1, 2, 3]) == {2}
    assert pool._dirty
    assert eng.metrics.counters["nonfinite_bisects"] == 1
    assert eng.metrics.counters["nonfinite_bisect_evals"] == 1


def test_real_watchdog_timeout(small_model):
    """With step_timeout_s=0 every step overruns its deadline on the real
    clock, so the request spends its retries and is rejected."""
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)], step_timeout_s=0.0)
    out = eng.run(_reqs(1, max_retries=1))[0]
    assert out.rejected and out.reject_reason == "step_failed:step_timeout"
    assert eng.metrics.counters["step_failures:step_timeout"] == 2


def test_recovery_time_recorded(small_model):
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)])
    with injected(FaultPlan(seed=0, at={"step_raise": (0,)})):
        eng.run(_reqs(1))
    assert len(eng.metrics.recovery_s) == 1
    s = eng.metrics.summary()
    assert s["recovery_p99_ms"] >= s["recovery_p50_ms"] > 0.0


# ---------------------------------------------------------------------------
# warmup-time faults
# ---------------------------------------------------------------------------


def test_compile_fail_warmup_retries(small_model):
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)])
    with injected(FaultPlan(seed=0, at={"compile_fail": (0,)})):
        eng.warmup()
    assert eng.metrics.counters["warmup_retries"] == 1
    assert eng.pools.pools[0].compiled()
    out = eng.run(_reqs(1))[0]
    assert out.done and not out.rejected


def test_compile_fail_persistent_raises(small_model):
    """Three compile failures in a row exhaust warmup's attempts and
    surface the error: a host that cannot build its steps is not warm."""
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)])
    with injected(FaultPlan(seed=0, at={"compile_fail": (0, 1, 2)})):
        with pytest.raises(InjectedFault):
            eng.warmup()
    assert eng.metrics.counters["warmup_retries"] == 3
    assert not eng.pools.pools[0].compiled()


def test_autotune_cache_unreadable_degrades(small_model):
    """An unreadable persistent autotune cache at warmup is survivable: the
    engine counts the degradation and still serves correctly."""
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)])
    with injected(FaultPlan(seed=0, at={"autotune_cache_load": (0,)})):
        eng.warmup()
    assert eng.metrics.counters["autotune_cache_load_failed"] == 1
    out = eng.run(_reqs(1))[0]
    assert out.done and not out.rejected


def test_corrupt_autotune_cache_degrades(small_model, tmp_path):
    """A corrupt cache file named by the config is counted like the
    injected fault, and the engine measures cold and serves."""
    path = tmp_path / "cache.json"
    path.write_text("{truncated")
    model = MaceGaunt(dataclasses.replace(small_model.cfg, chain_tune="measure",
                                          autotune_cache=str(path)), device="cpu")
    model.load_state_dict(small_model.state_dict())
    eng = EquivariantServeEngine(model, buckets=[(6, 1)])
    _engine.get_engine().clear()  # nothing measured in process: a cold host
    try:
        eng.warmup()
        assert eng.metrics.counters["autotune_cache_load_failed"] == 1
        assert _engine.get_engine().timing_runs > 0
        out = eng.run(_reqs(1))[0]
        assert out.done and not out.rejected
        assert json.loads(path.read_text())["selections"]  # repaired by the flush
    finally:
        _engine.get_engine().set_autotune_cache(None)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------


def test_straggler_flagged_is_capped():
    mon = StragglerMonitor(window=20, factor=2.0, max_flagged=8)
    for i in range(10):
        mon.record(i, 1.0)
    for i in range(100):
        mon.record(100 + i, 10.0)
    assert len(mon.flagged) == 8
    assert mon.total_flagged > 8


def test_straggler_count_in_serve_summary(small_model):
    eng = EquivariantServeEngine(small_model, buckets=[(6, 1)])
    for _ in range(12):
        eng.metrics.observe_step("b6", 1, 1, 3, 6, dur_s=1e-3)
    eng.metrics.observe_step("b6", 1, 1, 3, 6, dur_s=1.0)
    assert eng.metrics.summary()["straggler_steps"] == 1
    assert eng.metrics.per_pool["b6"]["straggler_steps"] == 1


# ---------------------------------------------------------------------------
# replica failover
# ---------------------------------------------------------------------------


def _factory(model, **kw):
    def make(i, metrics):
        return EquivariantServeEngine(model, buckets=[(6, 1)], metrics=metrics,
                                      tag=f"replica{i}", **kw)
    return make


def test_failover_preserves_priority_fifo_order(small_model):
    """A cordoned replica's in-flight request rejoins the queue at its
    original (priority, _seq) standing, is served ahead of lower-priority
    work queued after it, and completes with its fault-free numbers."""
    rset = ReplicaSet(_factory(small_model), n_replicas=2, max_fail_streak=2,
                      restart_backoff_s=60.0)
    doomed = EquivariantRequest(*_mol(4, seed=0), rid=0, priority=-1, steps=2,
                                step_size=0.01, max_retries=10)
    rest = [EquivariantRequest(*_mol(3 + i, seed=10 + i), rid=1 + i, steps=2,
                               step_size=0.01, max_retries=10) for i in range(3)]
    plan = FaultPlan(seed=0, rates={"step_raise": 1.0},
                     scope=lambda ctx: ctx.get("tag") == "replica0")
    with injected(plan):
        out = rset.run([doomed] + rest)
    assert all(r.done and not r.rejected for r in out)
    m = rset.metrics.summary()
    assert m["failovers"] >= 1 and m["requeued_on_failover"] >= 1
    assert doomed._seq == 0, "failover must not re-sequence the request"
    order = list(rset.metrics.completed_order)
    assert order.index(0) < order.index(3)
    base = EquivariantServeEngine(small_model, buckets=[(6, 2)]).run(
        [EquivariantRequest(*_mol(4, seed=0), rid=0, steps=2, step_size=0.01)])[0]
    assert doomed.energy == base.energy


def test_cordoned_replica_restarts_with_backoff(small_model):
    rset = ReplicaSet(_factory(small_model), n_replicas=2, max_fail_streak=1,
                      restart_backoff_s=0.0)
    plan = FaultPlan(seed=0, rates={"step_raise": 1.0}, max_fires=1,
                     scope=lambda ctx: ctx.get("tag") == "replica0")
    with injected(plan):
        out = rset.run(_reqs(4))
    assert all(r.done and not r.rejected for r in out)
    m = rset.metrics.summary()
    assert m["failovers:step_failures"] == 1 and m["replica_restarts"] == 1
    assert all(r.live for r in rset.replicas)


def test_heartbeat_stale_cordons(small_model, tmp_path):
    """A replica whose heartbeat file is stale is cordoned even if it never
    failed a step in-process."""
    rset = ReplicaSet(_factory(small_model), n_replicas=2, stale_after_s=30.0,
                      restart_backoff_s=60.0, heartbeat_dir=str(tmp_path))
    with open(rset.replicas[0].heartbeat.path, "w") as f:
        json.dump({"step": 0, "t": time.time() - 1e4, "pid": 0}, f)
    out = rset.run(_reqs(3))
    assert all(r.done and not r.rejected for r in out)
    assert rset.metrics.summary()["failovers:heartbeat_stale"] == 1
    assert not rset.replicas[0].live


def test_replicaset_through_scheduler_attaches_queue(small_model):
    rset = ReplicaSet(_factory(small_model), n_replicas=2)
    sched = Scheduler(rset)
    assert rset._queue is sched.queue
    Scheduler(EquivariantServeEngine(small_model, buckets=[(6, 1)]))  # no attach_queue


def test_each_replica_builds_its_own_steps(small_model):
    """Replicas share the model, not their buckets: each engine's warmup
    builds its own steps (on the card, its own captured graphs)."""
    rset = ReplicaSet(_factory(small_model, warmup=True), n_replicas=2)
    pools = [r.engine.pools.pools[0] for r in rset.replicas]
    assert pools[0] is not pools[1] and all(p.compiled() for p in pools)
    out = rset.run(_reqs(4))
    assert all(r.done and not r.rejected for r in out)
    assert all(p.steps_run > 0 for p in pools)


# ---------------------------------------------------------------------------
# acceptance: failover in a subprocess on a warm autotune cache
# ---------------------------------------------------------------------------

_FAILOVER_CHILD = r"""
import dataclasses, os
import numpy as np
import torch
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine
from repro_torch.serve.faults import FaultPlan, injected
from repro_torch.serve.replicas import ReplicaSet
from repro_torch.core import engine as ce

cfg = dataclasses.replace(gaunt_mace_ff, channels=4, n_layers=1, L=1, L_edge=1,
                          n_species=4, chain_tune="measure",
                          autotune_cache=os.environ["CACHE_PATH"])
model = MaceGaunt(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

def factory(i, metrics):
    eng = EquivariantServeEngine(model, buckets=[(6, 1)], metrics=metrics,
                                 tag=f"replica{i}")
    eng.warmup()
    return eng

rset = ReplicaSet(factory, n_replicas=2, max_fail_streak=2, restart_backoff_s=60.0)
g = ce.get_engine()
warm_runs = g.timing_runs
rng = np.random.default_rng(0)
reqs = [EquivariantRequest(species=rng.integers(0, 4, 3 + i % 3),
                           pos=(rng.normal(size=(3 + i % 3, 3)) * 1.5).astype(np.float32),
                           rid=i, steps=2, step_size=0.01, max_retries=10)
        for i in range(4)]
plan = FaultPlan(seed=0, rates={"step_raise": 1.0},
                 scope=lambda ctx: ctx.get("tag") == "replica0")
with injected(plan):
    rset.run(reqs)
assert all(r.done and not r.rejected for r in reqs), reqs
m = rset.metrics.summary()
assert m["failovers"] >= 1, m
assert not rset.replicas[0].live, "the failing replica must be cordoned"
g.flush_autotune_cache()
print("RUNS=" + str(g.timing_runs))
print("MIDSERVE=" + str(g.timing_runs - warm_runs))
print("FAILOVER_OK")
"""


def test_failover_completes_on_survivor_with_warm_cache(tmp_path):
    """In a fresh process one replica of a ReplicaSet fails every step, is
    cordoned, and its requests complete on the survivor; in a second
    process on the warm cache the whole run, warmup included, makes zero
    timing runs, and neither process measures mid-serve."""
    from test_torch_autotune_cache import run_twice

    cold, warm = run_twice(_FAILOVER_CHILD, str(tmp_path / "failover_cache.json"),
                           "FAILOVER_OK")
    assert int(cold["RUNS"]) > 0, "the cold process should have measured"
    assert int(cold["MIDSERVE"]) == 0 and int(warm["MIDSERVE"]) == 0, \
        "failover recovery must never trigger mid-serve timing runs"
    assert int(warm["RUNS"]) == 0, f"warm process ran {warm['RUNS']} timing passes"
