"""step_device_ms.serve: the device time of a served step, the port's span
``evaluate`` (the energy and the force backward of every slot, inside the
bucket's graph), over the steps (``evaluate`` calls) before the traced
part of the window, in ms; snapshotted at the trace mark with the spans on
(`perfbench.trace.span_ms`).  Nothing to read without the spans."""
from perfbench.trace import span_ms


def read(run):
    return span_ms(run, "serve", "evaluate")
