"""setup_s: seconds from the process's start to the window's: imports,
weights, the model, the engine's warmup (kernel builds, the autotune
cache, graph captures) and the untimed warm round or steps."""


def read(run):
    return run["setup_s"]
