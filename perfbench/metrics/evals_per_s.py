"""evals_per_s: energy-and-forces evaluations completed in the window (a
failed one not counted), over the window's seconds (host clock)."""


def read(run):
    if run["kind"] != "serve":
        return None
    done = sum(1 for r in run["records"]
               if r["t_done"] <= run["t_close"] and not r["failed"])
    return done / (run["t_close"] - run["t0"])
