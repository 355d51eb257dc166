"""loss_ms.train: the device time a training step of the loss, the forward
and the force gradient with its graph kept (the port's span ``loss``),
over the steps before the traced part of the window, in ms
(`perfbench.trace.span_ms`).  Nothing to read without the spans."""
from perfbench.trace import span_ms


def read(run):
    return span_ms(run, "train", "loss")
