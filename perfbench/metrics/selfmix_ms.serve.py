"""selfmix_ms.serve: the device time a served step of the Gaunt Selfmix of
every block, the chain and its channel mix (the port's span ``selfmix``),
over the steps (``evaluate`` calls) before the traced part of the window,
in ms (`perfbench.trace.span_ms`).  Nothing to read without the spans."""
from perfbench.trace import span_ms


def read(run):
    return span_ms(run, "serve", "selfmix")
