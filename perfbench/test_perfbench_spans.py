"""What the benchmark reads of the port's own timing: `host_gap_ms.serve`
on synthetic run records and on a serve cell driven at CPU size, nothing
where the program keeps no host gaps, and an idle gap named by the port's
``rt.`` span where it is the innermost host range."""
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
