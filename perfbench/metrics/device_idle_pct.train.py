"""device_idle_pct.train: the share of the traced window in which nothing ran
on the device (`torch.profiler`, graph replays included)."""
from perfbench.trace import idle_pct


def read(run):
    return idle_pct(run, "train")
