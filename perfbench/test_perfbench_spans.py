"""What the benchmark reads of the port's own timing: `host_gap_ms.serve`
on synthetic run records and on a serve cell driven at CPU size, nothing
where the program keeps no host gaps, an idle gap named by the port's
``rt.`` span where it is the innermost host range, and the span metrics
(a span's device time a step before the trace mark) on synthetic records
and on traced runs at CPU size with the spans on."""
import time
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import bench, run
from perfbench.trace import SPAN_PREFIX, Tracer

host_gap = bench.metric_reader("host_gap_ms.serve")


def _serve_run(samples, t_mark=10.0):
    return {"kind": "serve", "marks": {"t": t_mark},
            "metrics": SimpleNamespace(host_gap=samples)}


def test_host_gap_reads_the_steps_before_the_mark():
    run_ = _serve_run([(5.0, 0.010), (9.0, 0.020), (10.0, 0.030), (11.0, 1.0)])
    assert host_gap(run_) == pytest.approx(20.0)


@pytest.mark.parametrize("run_", [
    {"kind": "train", "marks": {"t": 1.0}},
    {"kind": "serve", "marks": {}, "metrics": SimpleNamespace(host_gap=[(0.5, 0.1)])},
    _serve_run([(11.0, 0.1)]),
    # a program without the samples (the parent of the port's spans)
    {"kind": "serve", "marks": {"t": 1.0}, "metrics": SimpleNamespace()},
], ids=["train", "untraced", "none_before_mark", "no_samples"])
def test_host_gap_nothing_to_read(run_):
    assert host_gap(run_) is None


def test_host_gap_of_a_cell_at_cpu_size(tiny):
    """The closed loop's gaps through the real path: one fewer a bucket
    than its steps in the window, each a positive host time."""
    res, _, rec = run.run_cell("mace_escn.md_3bpa", 2 ** 32 + 5, 0.4, False, "cpu",
                               time.perf_counter())
    assert res["correct"]
    steps = rec["metrics"].counters["steps"]
    gaps = rec["metrics"].host_gap
    assert 0 < len(gaps) <= steps and all(g > 0 for _, g in gaps)
    v = host_gap(dict(rec, marks={"t": rec["t_close"]}))
    assert 0 < v < 1e3 * rec["window_s"]


def test_gap_named_by_the_ports_innermost_span():
    merged = [[0, 10], [20, 30]]
    host = [(0, 50, SPAN_PREFIX + "scheduler_pump"), (1, 49, "rt.pump"),
            (11, 19, "rt.retire")]
    gaps = Tracer._gaps(np.asarray(merged, dtype=float), host)
    assert gaps[0][0] == SPAN_PREFIX + "scheduler_pump > rt.retire"
    assert gaps[0][1] == pytest.approx(10e-6)


SPAN_METRICS = [("step_device_ms.serve", "serve", "evaluate"),
                ("conv_ms.serve", "serve", "conv"),
                ("manybody_ms.serve", "serve", "manybody"),
                ("force_backward_ms.serve", "serve", "force_backward"),
                ("loss_ms.train", "train", "loss"),
                ("param_grad_ms.train", "train", "param_grad"),
                ("optimizer_ms.train", "train", "optimizer")]


def _span_run(kind, name, device_s, steps):
    other = {"calls": 3, "device_s": 9.0}
    return {"kind": kind, "spans": {"steps": steps,
                                    "totals": {name: {"calls": 2 * steps, "device_s": device_s},
                                               "other": other}}}


@pytest.mark.parametrize("metric,kind,name", SPAN_METRICS, ids=[m[0] for m in SPAN_METRICS])
def test_span_metric_is_device_ms_a_step(metric, kind, name):
    """A span entered once a layer (two calls a step) counts whole a step."""
    read = bench.metric_reader(metric)
    assert read(_span_run(kind, name, 0.9, 4)) == pytest.approx(225.0)
    other = "train" if kind == "serve" else "serve"
    assert read(_span_run(other, name, 0.9, 4)) is None


@pytest.mark.parametrize("metric,kind,name", SPAN_METRICS, ids=[m[0] for m in SPAN_METRICS])
def test_span_metric_nothing_to_read(metric, kind, name):
    read = bench.metric_reader(metric)
    assert read({"kind": kind, "spans": None}) is None            # spans off or absent
    assert read({"kind": kind}) is None
    assert read(_span_run(kind, name, 0.9, 0)) is None             # no step before the mark
    assert read(_span_run(kind, "elsewhere", 0.9, 4)) is None      # the span never ran
    assert read(_span_run(kind, name, 0.0, 4)) is None             # host time only (CPU)


@pytest.fixture
def spans_on():
    from repro_torch import spans

    prev = spans.set_enabled(True)
    spans.reset()
    yield spans
    spans.set_enabled(prev)
    spans.reset()


@pytest.mark.parametrize("cell,step_span", [("mace_escn.md_3bpa", "evaluate"),
                                            ("mace_escn.train_3bpa", "loss")])
def test_traced_run_carries_the_span_snapshot(tiny, spans_on, cell, step_span):
    """A traced run at CPU size with the spans on keeps, at its trace mark,
    the spans' totals and the steps before the mark: the step's span was
    entered once a step, the conv or loss stages inside it too."""
    res, _, rec = run.run_cell(cell, 2 ** 32 + 9, 0.6, True, "cpu", time.perf_counter())
    assert res["attempted"] > 0 and res["failed"] == 0
    snap = rec["spans"]
    assert snap["steps"] > 0
    assert snap["totals"][step_span]["calls"] == snap["steps"]
    inner = "conv" if step_span == "evaluate" else "param_grad"
    assert snap["totals"][inner]["calls"] >= snap["steps"]
    assert snap["totals"][step_span]["host_s"] > 0
    assert rec["trace"]["window_s"] > 0
    # CPU spans time the host alone: no device metric is read from them
    assert not [m for m, _, _ in SPAN_METRICS if bench.metric_reader(m)(rec) is not None]


def test_untraced_run_keeps_no_snapshot(tiny, spans_on):
    _, _, rec = run.run_cell("mace_escn.md_3bpa", 2 ** 32 + 9, 0.3, False, "cpu",
                             time.perf_counter())
    assert rec["spans"] is None
