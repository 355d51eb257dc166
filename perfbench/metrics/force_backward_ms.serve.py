"""force_backward_ms.serve: the device time a served step of the force
backward, the gradient of the summed energies to the positions (the
port's span ``force_backward``), over the steps (``evaluate`` calls)
before the traced part of the window, in ms (`perfbench.trace.span_ms`).
Nothing to read without the spans."""
from perfbench.trace import span_ms


def read(run):
    return span_ms(run, "serve", "force_backward")
