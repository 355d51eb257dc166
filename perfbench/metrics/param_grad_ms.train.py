"""param_grad_ms.train: the device time a training step of the gradient to
the parameters, the double backward (the port's span ``param_grad``),
over the steps before the traced part of the window, in ms
(`perfbench.trace.span_ms`).  Nothing to read without the spans."""
from perfbench.trace import span_ms


def read(run):
    return span_ms(run, "train", "param_grad")
