"""The trace reduction on synthetic intervals: the union of device
activity, idle gaps named by the host's span and innermost operation, and
kernel names cut to head and tail."""
import numpy as np

from perfbench.trace import SPAN_PREFIX, Tracer, _union, short


def test_union_merges_overlaps():
    iv = np.asarray([[0, 2], [1, 3], [5, 6], [6, 7]], dtype=float)
    np.testing.assert_array_equal(_union(iv), [[0, 3], [5, 7]])


def test_gaps_named_by_span_and_innermost_op():
    merged = np.asarray([[0, 10], [20, 30], [31, 40]], dtype=float)
    host = [(0, 50, SPAN_PREFIX + "scheduler_pump"), (12, 18, "cudaGraphLaunch"),
            (11, 19, "aten::copy_")]
    gaps = Tracer._gaps(merged, host)
    assert gaps[0][0] == SPAN_PREFIX + "scheduler_pump > cudaGraphLaunch"
    assert abs(gaps[0][1] - 10e-6) < 1e-12
    assert abs(sum(g[1] for g in gaps) - 11e-6) < 1e-12


def test_short_keeps_head_and_tail():
    name = "a" * 150 + "complex<float>"
    s = short(name)
    assert s.startswith("a" * 100) and s.endswith("complex<float>") and len(s) == 160
    assert short("gaunt_chain_kernel") == "gaunt_chain_kernel"
