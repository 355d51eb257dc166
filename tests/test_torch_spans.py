"""The port's spans (`repro_torch.spans`): off they record nothing and
cost no profiler range or event; on, they nest, give parents and self
time, count each layer's stages once, leave every output bitwise as it was,
and reach `ServeMetrics.summary`.  The pools' host gaps and the conversion
counters of a served step.  On the card (marked ``cuda``): a bucket's graph
captured with spans on reads its stages' device times after each replay,
and one captured with spans off holds no event node."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.config import TrainConfig
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.core.rep import conversion_stats
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Scheduler
from repro_torch.train import make_train_step

MODEL_SPANS = ("geometry", "radial", "conv", "mix", "manybody", "mb_mix", "readout")
CONV_CHILDREN = {
    "escn": ("conv.rotate", "conv.to_fourier", "conv.filter", "conv.to_sh",
             "conv.rotate_back"),
    "general": ("conv.to_fourier", "conv.conv2d", "conv.to_sh"),
}


@pytest.fixture
def spans_on():
    """Spans on for one test, with empty totals before and after."""
    prev = spans.set_enabled(True)
    spans.reset()
    yield
    spans.set_enabled(prev)
    spans.reset()


@pytest.fixture
def spans_off():
    prev = spans.set_enabled(False)
    spans.reset()
    yield
    spans.set_enabled(prev)
    spans.reset()


def _cfg(conv_impl="escn", **kw):
    return dataclasses.replace(gaunt_mace_ff, channels=4, n_layers=2, L=2, L_edge=3,
                               n_species=4, chain_tune="heuristic", grid_gate="on",
                               conv_impl=conv_impl, **kw)


def _model(conv_impl="escn", device="cpu", **kw):
    return MaceGaunt(_cfg(conv_impl, **kw), device=device,
                     generator=torch.Generator().manual_seed(3))


def _mols(S=2, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 4, (S, n))),
            torch.as_tensor((rng.normal(size=(S, n, 3)) * 1.5).astype(np.float32)))


def _batch(seed=1):
    sp, pos = _mols(3, 5, seed)
    rng = np.random.default_rng(seed + 100)
    return {"species": sp, "pos": pos,
            "energy": torch.as_tensor(rng.normal(size=3).astype(np.float32)),
            "forces": torch.as_tensor(rng.normal(size=(3, 5, 3)).astype(np.float32))}


def _train_steps(model, n=2):
    step, opt = make_train_step(lambda m, b: (m.loss(b), {}), TrainConfig(warmup_steps=0))
    state = opt.init(dict(model.named_parameters()))
    losses = []
    for i in range(n):
        state, metrics = step(model, state, _batch(i))
        losses.append(metrics["loss"])
    return losses


def test_off_records_nothing(spans_off, monkeypatch):
    """No profiler range, no event and no totals after a served evaluation
    and a training step; every off span is one shared context."""
    def refuse(*a, **k):
        raise AssertionError("a span that is off made a range or an event")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert spans.span("a") is spans.span("b", torch.zeros(1))
    model = _model()
    model.energy_forces(*_mols())
    _train_steps(model, 1)
    assert spans.totals() == {}
    with spans.capture() as events:
        pass
    assert events == []


def test_nesting_parents_and_self_time(spans_on):
    with spans.span("outer"):
        time.sleep(0.02)
        for _ in range(2):
            with spans.span("inner"):
                time.sleep(0.01)
    t = spans.totals()
    assert t["outer"]["calls"] == 1 and t["inner"]["calls"] == 2
    assert t["outer"]["parents"] == [None] and t["inner"]["parents"] == ["outer"]
    assert t["outer"]["host_s"] >= 0.04 and t["inner"]["host_s"] >= 0.02
    assert t["outer"]["host_self_s"] == pytest.approx(
        t["outer"]["host_s"] - t["inner"]["host_s"], rel=1e-9)
    assert t["outer"]["host_self_s"] >= 0.02
    assert t["inner"]["host_self_s"] == t["inner"]["host_s"]
    assert t["inner"]["device_s"] == 0.0 and t["outer"]["device_self_s"] == 0.0
    with spans.span("inner"):
        pass
    assert spans.totals()["inner"]["parents"] == [None, "outer"]


def test_observe_and_reset(spans_on):
    before = time.perf_counter()
    spans.reset()
    now = time.perf_counter()
    spans.observe("host_gap", now, now + 0.25)
    spans.observe("host_gap", now, now + 0.5)
    spans.observe("host_gap", before, now + 1.0)   # began before the reset
    t = spans.totals()["host_gap"]
    assert t["calls"] == 2 and t["host_s"] == pytest.approx(0.75)
    assert t["host_self_s"] == pytest.approx(0.75) and t["parents"] == [None]
    spans.reset()
    assert spans.totals() == {}


@pytest.mark.parametrize("conv_impl", ["escn", "general"])
def test_model_spans_once_per_layer(spans_on, conv_impl):
    model = _model(conv_impl)
    model.energy_forces(*_mols())
    t = spans.totals()
    n_layers = model.cfg.n_layers
    for name in MODEL_SPANS:
        want = 1 if name in ("geometry", "readout") else n_layers
        assert t[name]["calls"] == want, name
        assert t[name]["parents"] == [None], name
    for name in CONV_CHILDREN[conv_impl]:
        assert t[name]["calls"] == n_layers and t[name]["parents"] == ["conv"], name
    children = sum(t[name]["host_s"] for name in CONV_CHILDREN[conv_impl])
    assert t["conv"]["host_self_s"] == pytest.approx(t["conv"]["host_s"] - children)
    assert 0 < children < t["conv"]["host_s"]


@pytest.mark.parametrize("conv_impl", ["escn", "general"])
def test_outputs_bitwise_equal_with_spans(spans_off, conv_impl):
    """Energies, forces, losses and the trained parameters are bitwise the
    same with spans on and off."""
    out = {}
    for on in (False, True):
        spans.set_enabled(on)
        model = _model(conv_impl)
        e, f = model.energy_forces(*_mols())
        # the general conv's double backward is slow on the CPU; the
        # training step's spans are the same on either conv
        losses = _train_steps(model, 2 if conv_impl == "escn" else 0)
        out[on] = [e, f, *losses, *(p.detach() for p in model.parameters())]
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


def test_training_step_spans(spans_on):
    model = _model()
    _train_steps(model, 2)
    t = spans.totals()
    for name in ("loss", "param_grad", "clip", "optimizer"):
        assert t[name]["calls"] == 2 and t[name]["parents"] == [None], name
    assert t["conv"]["calls"] == 2 * model.cfg.n_layers
    assert t["conv"]["parents"] == ["loss"]
    assert t["loss"]["host_self_s"] < t["loss"]["host_s"]


def _serve(model, n_req=6, steps=1):
    """Requests through the scheduler's pump, as a serving loop drives it."""
    eng = EquivariantServeEngine(model, buckets=[(6, 2)], warmup=True)
    reqs = [EquivariantRequest(*(a[0].numpy() for a in _mols(1, 4 + i % 3, 20 + i)),
                               steps=steps, rid=i) for i in range(n_req)]
    sched = Scheduler(eng)
    for r in reqs:
        sched.submit(r)
    while sched.pump():
        pass
    return eng, reqs


def test_serve_spans_reach_summary(spans_on):
    model = _model()
    eng, reqs = _serve(model)
    assert all(r.done and not r.rejected for r in reqs)
    s = eng.metrics.summary()
    steps = eng.metrics.counters["steps"]
    # on the CPU the step is the eager evaluation: one call a step, plus
    # the warmup's
    assert s["span:evaluate:calls"] == steps + 1
    assert s["span:conv:calls"] == (steps + 1) * model.cfg.n_layers
    for name in ("admit", "pump", "stage", "wait_outputs", "retire", "energy",
                 "force_backward"):
        assert s[f"span:{name}:calls"] > 0 and s[f"span:{name}:host_ms"] > 0, name
        assert s[f"span:{name}:device_ms"] == 0.0
    t = spans.totals()
    assert t["energy"]["parents"] == ["evaluate"] and t["conv"]["parents"] == ["energy"]
    assert t["admit"]["parents"] == ["pump"]
    # host gaps between consecutive steps of the bucket: one fewer than its steps
    assert s["span:host_gap:calls"] == steps - 1 == len(eng.metrics.host_gap)
    assert s["conversions"] == dict(conversion_stats())


def test_serve_outputs_equal_with_spans(spans_off):
    out = {}
    for on in (False, True):
        spans.set_enabled(on)
        _, reqs = _serve(_model(), steps=2)
        out[on] = [(r.energy, r.forces) for r in reqs]
    for (e0, f0), (e1, f1) in zip(out[False], out[True]):
        assert e0 == e1 and np.array_equal(f0, f1)


def test_host_gap_samples_and_reset(spans_off):
    """The gap samples are kept with spans off; a gap that began before
    `reset` is dropped."""
    model = _model()
    eng, _ = _serve(model, n_req=6)
    gaps = eng.metrics.host_gap
    assert len(gaps) == eng.metrics.counters["steps"] - 1
    assert all(g > 0 and end > 0 for end, g in gaps)
    m = ServeMetrics()
    t0 = time.perf_counter()
    m.reset()
    m.observe_host_gap(t0, t0 + 1.0)
    m.observe_host_gap(time.perf_counter(), time.perf_counter() + 0.5)
    assert len(m.host_gap) == 1 and m.host_gap[0][1] == pytest.approx(0.5, abs=1e-3)
    assert "span:host_gap:calls" not in eng.metrics.summary()


# --------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 GPU: the captured graph's events exist only there")
    from repro_torch.device import set_float32_policy

    set_float32_policy()
    return torch.device("cuda")


def _event_nodes(graph, tmp_path, tag):
    path = tmp_path / f"{tag}.dot"
    graph.debug_dump(str(path))
    text = path.read_text()
    assert "KERNEL" in text        # the dump holds the graph's nodes
    return text.count("EVENT_RECORD")


def _debug_graphs(monkeypatch) -> list:
    """Make every CUDA graph keep its nodes for `debug_dump`; returns the
    list of the graphs made."""
    made, real = [], torch.cuda.graphs.CUDAGraph

    def make():
        g = real(keep_graph=True)
        g.enable_debug_mode()
        made.append(g)
        return g
    monkeypatch.setattr(torch.cuda, "CUDAGraph", make)
    return made


def _served_on_card(device, on, monkeypatch, conv_impl="escn"):
    spans.set_enabled(on)
    spans.reset()
    graphs = _debug_graphs(monkeypatch)
    model = _model(conv_impl, device=device)
    eng = EquivariantServeEngine(model, buckets=[(8, 4)], warmup=True)
    spans.reset()
    reqs = [EquivariantRequest(*(a[0].numpy() for a in _mols(1, 5 + i % 3, 40 + i)),
                               steps=3, rid=i) for i in range(8)]
    eng.run(reqs)
    (graph,) = graphs
    return eng, reqs, spans.totals(), graph


@pytest.mark.cuda
@pytest.mark.parametrize("conv_impl", ["escn", "general"])
def test_graph_stage_times_on_card(spans_off, cuda_device, monkeypatch, tmp_path,
                                   conv_impl):
    eng_off, reqs_off, t_off, g_off = _served_on_card(cuda_device, False, monkeypatch,
                                                      conv_impl)
    (pool_off,) = eng_off.pools
    nodes_off = _event_nodes(g_off, tmp_path, "off")
    eng_on, reqs_on, t_on, g_on = _served_on_card(cuda_device, True, monkeypatch, conv_impl)
    (pool_on,) = eng_on.pools
    nodes_on = _event_nodes(g_on, tmp_path, "on")
    # off: no event in the graph and nothing recorded
    assert pool_off._span_events == [] and nodes_off == 0 and t_off == {}
    # on: two event nodes a span, each stage read after every replay
    assert nodes_on == 2 * len(pool_on._span_events) > 0
    steps = eng_on.metrics.counters["steps"]
    assert t_on["evaluate"]["calls"] == steps
    for name in ("evaluate", "energy", "force_backward", "geometry", "conv", "manybody",
                 *CONV_CHILDREN[conv_impl]):
        assert t_on[name]["device_s"] > 0, name
    ev = t_on["evaluate"]["device_s"]
    assert t_on["energy"]["device_s"] + t_on["force_backward"]["device_s"] <= ev
    assert sum(t_on[n]["device_s"] for n in MODEL_SPANS) <= t_on["energy"]["device_s"]
    assert t_on["evaluate"]["device_self_s"] >= 0
    for a, b in zip(reqs_off, reqs_on):
        assert a.energy == b.energy and np.array_equal(a.forces, b.forces)
    # the graph's conversions tick once a replay, as an eager step's would
    before = dict(conversion_stats())
    pool_on.step_staged()
    after = conversion_stats()
    assert pool_on.conversions and pool_on.conversions == {
        k: after[k] - before[k] for k in after if after[k] != before[k]}
