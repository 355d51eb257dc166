"""manybody_ms.serve: the device time a served step of the many-body chain
stage, both layers (the port's span ``manybody``: the weights' expand,
the chain kernel, the fused gate), over the steps (``evaluate`` calls)
before the traced part of the window, in ms (`perfbench.trace.span_ms`).
Nothing to read without the spans."""
from perfbench.trace import span_ms


def read(run):
    return span_ms(run, "serve", "manybody")
