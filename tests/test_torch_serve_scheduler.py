"""The port's serve scheduler and slot pools, against the reference's
`tests/test_serve_scheduler.py`: deadline expiry, priority then FIFO,
requeue that keeps its standing, the metrics gauges, the bucket ladder (the
same as the reference's for every cap), selection boundaries, and the proof
that a small-bucket workload never builds the large bucket's step."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.gaunt_ff import gaunt_mace_ff as ref_cfg
from repro.models.equivariant import MaceGaunt as RefMace
from repro.serve.pools import default_buckets as ref_default_buckets
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.models.convert import params_from_jax
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine
from repro_torch.serve.metrics import ServeMetrics, percentile
from repro_torch.serve.pools import BucketedPools, BucketSpec, default_buckets
from repro_torch.serve.scheduler import (AdmissionQueue, REASON_DEADLINE,
                                         REASON_INVALID, Scheduler)

SMALL = dict(channels=8, n_layers=1, L=1, L_edge=1, n_species=4)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass
class _Req:
    rid: int = 0
    priority: int = 0
    deadline: float | None = None
    invalid: str | None = None   # stub validation verdict
    done: bool = False
    rejected: bool = False
    reject_reason: str | None = None


class _StubEngine:
    """Capacity-limited engine stub: records admission order, completes
    every active request per step."""

    def __init__(self, capacity: int = 1):
        self.capacity = capacity
        self.active: list[_Req] = []
        self.admitted_order: list[int] = []
        self.metrics = None

    def validate(self, req):
        return (REASON_INVALID, req.invalid) if req.invalid else None

    def try_admit(self, req) -> bool:
        if len(self.active) >= self.capacity:
            return False
        self.active.append(req)
        self.admitted_order.append(req.rid)
        return True

    def has_active(self) -> bool:
        return bool(self.active)

    def step(self, overlap=None):
        stepping, self.active = self.active, []
        if overlap is not None:
            overlap()
        for r in stepping:
            r.done = True


# --------------------------------------------------------------- the queue


def test_queue_priority_order_fifo_within_class():
    q = AdmissionQueue(FakeClock())
    for rid, prio in [(0, 1), (1, 0), (2, 1), (3, 0), (4, 2)]:
        q.submit(_Req(rid=rid, priority=prio))
    assert [q.pop().rid for _ in range(len(q))] == [1, 3, 0, 2, 4]


def test_queue_expire_removes_only_stale():
    clock = FakeClock()
    q = AdmissionQueue(clock)
    q.submit(_Req(rid=0, deadline=1.0))
    q.submit(_Req(rid=1, deadline=5.0))
    q.submit(_Req(rid=2))                  # no deadline: never expires
    clock.advance(2.0)
    assert [r.rid for r in q.expire()] == [0]
    assert len(q) == 2


def test_queue_requeue_preserves_fifo_standing():
    q = AdmissionQueue(FakeClock())
    a, b = _Req(rid=0), _Req(rid=1)
    q.submit(a)
    q.submit(b)
    assert q.pop() is a
    q.requeue(a)                       # blocked, not consumed
    assert q.pop() is a                # still ahead of b
    assert q.pop() is b


# ----------------------------------------------------------- the scheduler


def test_deadline_expired_rejected_with_structured_reason():
    clock = FakeClock()
    eng = _StubEngine(capacity=1)
    sched = Scheduler(eng, clock=clock, metrics=ServeMetrics(clock=clock))
    fresh, stale = _Req(rid=0), _Req(rid=1, deadline=0.5)
    sched.submit(fresh)
    sched.submit(stale)
    clock.advance(1.0)                 # stale's queue wait exceeds its deadline
    sched.drain()
    assert fresh.done and not fresh.rejected
    assert stale.rejected and stale.done
    assert stale.reject_reason.startswith(REASON_DEADLINE)
    assert sched.metrics.counters[f"rejected:{REASON_DEADLINE}"] == 1
    assert eng.admitted_order == [0]


def test_admission_respects_priority_then_fifo():
    eng = _StubEngine(capacity=1)      # serial: admission order observable
    sched = Scheduler(eng, clock=FakeClock())
    reqs = [_Req(rid=0, priority=1), _Req(rid=1, priority=0),
            _Req(rid=2, priority=1), _Req(rid=3, priority=0)]
    sched.run(list(reqs))
    assert all(r.done for r in reqs)
    assert eng.admitted_order == [1, 3, 0, 2]


def test_blocked_request_requeued_without_losing_position():
    eng = _StubEngine(capacity=1)
    sched = Scheduler(eng, clock=FakeClock())
    a, b, c = _Req(rid=0), _Req(rid=1), _Req(rid=2)
    sched.submit(a)
    sched.submit(b)
    assert sched.admit_ready() == 1    # a admitted, b blocked and requeued
    sched.submit(c)
    eng.step()                         # a completes, capacity frees
    sched.drain()
    assert eng.admitted_order == [0, 1, 2]


def test_invalid_requests_rejected_by_engine_validator():
    eng = _StubEngine(capacity=4)
    sched = Scheduler(eng, clock=FakeClock())
    bad, good = _Req(rid=0, invalid="broken geometry"), _Req(rid=1)
    sched.run([bad, good])
    assert bad.rejected and bad.reject_reason == f"{REASON_INVALID}:broken geometry"
    assert good.done and not good.rejected
    assert eng.admitted_order == [1]


# ------------------------------------------------------------ the metrics


def test_percentile_interpolates():
    assert percentile([], 99) == 0.0
    assert percentile([5.0], 50) == 5.0
    xs = list(range(1, 101))
    assert percentile(xs, 50) == pytest.approx(50.5)
    assert percentile(xs, 99) == pytest.approx(99.01)
    assert percentile(xs, 100) == 100.0


def test_metrics_padding_and_occupancy_gauges():
    m = ServeMetrics(clock=FakeClock())
    m.observe_step("small", active=2, n_slots=4, real_atoms=6, padded_atoms=12, dur_s=0.01)
    m.observe_step("large", active=1, n_slots=4, real_atoms=20, padded_atoms=64, dur_s=0.02)
    assert m.padding_efficiency() == pytest.approx(26 / 76)
    assert m.occupancy_mean() == pytest.approx(3 / 8)
    s = m.summary()
    assert s["steps"] == 2
    assert s["pool:small:padding_efficiency"] == pytest.approx(0.5)
    assert s["step_p50_ms"] == pytest.approx(15.0)
    # the engine's timing runs and the basis-conversion counters, as the
    # reference's summary gives them
    assert "engine_timing_runs" in s and set(s["conversions"]) == {
        "sh_to_fourier", "fourier_to_sh", "sh_to_quad", "quad_to_sh", "fourier_to_quad",
        "quad_to_fourier"}


def test_metrics_summary_keys_match_reference():
    from repro.serve.metrics import ServeMetrics as RefMetrics

    def drive(m):
        m.observe_step("b4", 1, 2, 3, 4, dur_s=0.01)
        m.observe_step_failure("b4", "step_raised")
        m.observe_retry("b4", "step_raised")
        m.observe_failover("replica0", "step_failures", 1)
        return m.summary()

    got = set(drive(ServeMetrics(clock=FakeClock())))
    want = set(drive(RefMetrics(clock=FakeClock())))
    assert got == want


def test_metrics_latency_pipeline():
    clock = FakeClock()
    m = ServeMetrics(clock=clock)
    r = _Req()
    m.observe_submit(r)
    clock.advance(0.5)
    m.observe_admit(r)
    clock.advance(1.5)
    m.observe_complete(r)
    s = m.summary()
    assert s["queue_wait_p50_ms"] == pytest.approx(500.0)
    assert s["latency_p50_ms"] == pytest.approx(2000.0)
    assert s["completed"] == 1


# ----------------------------------------------------------------- buckets


def test_default_buckets_ladder():
    specs = default_buckets(256, n_slots=4)
    assert [s.max_atoms for s in specs] == [64, 128, 256]
    assert [s.name for s in specs] == ["small", "medium", "large"]
    assert all(s.n_slots == 4 for s in specs)
    assert [s.max_atoms for s in default_buckets(4)] == [2, 4]
    assert [s.max_atoms for s in default_buckets(2)] == [2]
    assert [s.label() for s in default_buckets(32)] == ["small", "medium", "large"]
    assert BucketSpec(12, 2).label() == "b12"


def test_default_buckets_match_reference():
    for cap in range(2, 257):
        got = [(s.max_atoms, s.n_slots, s.name) for s in default_buckets(cap, n_slots=3)]
        want = [(s.max_atoms, s.n_slots, s.name)
                for s in ref_default_buckets(cap, n_slots=3)]
        assert got == want, cap


def test_duplicate_bucket_sizes_rejected():
    with pytest.raises(ValueError):
        BucketedPools(None, [BucketSpec(8, 1), BucketSpec(8, 2)])


@pytest.fixture(scope="module")
def small_model():
    ref = RefMace(dataclasses.replace(ref_cfg, **SMALL))
    params = ref.init(jax.random.PRNGKey(0))
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **SMALL), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model


def test_bucket_selection_boundaries(small_model):
    """select() routes to the smallest bucket that fits, with exact boundary
    behaviour at every bucket edge."""
    pools = BucketedPools(small_model, [BucketSpec(4, 1), BucketSpec(8, 1),
                                        BucketSpec(16, 1)])
    assert pools.select(1).spec.max_atoms == 4
    assert pools.select(4).spec.max_atoms == 4    # exact fit
    assert pools.select(5).spec.max_atoms == 8    # boundary + 1: next bucket
    assert pools.select(8).spec.max_atoms == 8
    assert pools.select(9).spec.max_atoms == 16
    assert pools.select(16).spec.max_atoms == 16
    assert pools.select(17) is None
    assert pools.max_atoms == 16


def _mol(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, n), (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)


def test_small_requests_never_build_the_large_bucket(small_model):
    """A workload that fits the small bucket never builds the large
    bucket's step (on the card: never captures its graph) and never steps
    it; the large bucket still works when a large request arrives."""
    eng = EquivariantServeEngine(small_model, buckets=[(4, 2), (12, 2)])
    small_pool, large_pool = eng.pools.pools
    assert not small_pool.compiled() and not large_pool.compiled()
    reqs = [EquivariantRequest(*_mol(2 + i % 3, seed=i), rid=i) for i in range(5)]
    out = eng.run(reqs)
    assert all(r.done and not r.rejected for r in out)
    assert small_pool.compiled() and small_pool.steps_run > 0
    assert not large_pool.compiled(), "a small-bucket workload built the large bucket's step"
    assert large_pool.steps_run == 0
    assert "large" not in {k.split(":")[1] for k in eng.metrics.summary() if ":" in k}
    big = EquivariantRequest(*_mol(10, seed=99), rid=99)
    eng.run([big])
    assert big.done and large_pool.compiled() and large_pool.steps_run == 1


def test_cpu_pool_has_no_graph(small_model):
    """On the CPU the step is the eager evaluation: nothing is captured and
    no kernel launch is counted at a replay."""
    eng = EquivariantServeEngine(small_model, buckets=[(6, 2)], warmup=True)
    pool = eng.pools.pools[0]
    assert pool.compiled() and pool._graph is None and pool.replays == 0
    assert pool.capture_s is None and pool.graph_bytes is None and pool.launches == {}
