"""train_step_ms: the window's seconds (closed by a synchronisation) over
the optimizer steps completed in it."""


def read(run):
    if run["kind"] != "train" or not run["steps"]:
        return None
    return run["window_s"] / run["steps"] * 1e3
