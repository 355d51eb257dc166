"""ffn_ms.serve: the device time a served step of the feed-forward network of
every block on the S^2 grid, its separable norm and residual included (the
port's span ``ffn``), over the steps (``evaluate`` calls) before the
traced part of the window, in ms (`perfbench.trace.span_ms`).  Nothing to
read without the spans."""
from perfbench.trace import span_ms


def read(run):
    return span_ms(run, "serve", "ffn")
