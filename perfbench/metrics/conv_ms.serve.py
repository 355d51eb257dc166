"""conv_ms.serve: the device time a served step of the forward equivariant
conv and its neighbour sum, both layers (the port's span ``conv``), over
the steps (``evaluate`` calls) before the traced part of the window, in ms
(`perfbench.trace.span_ms`).  Nothing to read without the spans."""
from perfbench.trace import span_ms


def read(run):
    return span_ms(run, "serve", "conv")
