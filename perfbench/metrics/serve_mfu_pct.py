"""serve_mfu_pct: model FLOPs of the evaluations completed before the
traced part of the window (`perfbench.work.serve_flops` at each
molecule's atom count) over that time and 67 TFLOP/s (f32)."""
from perfbench import work


def read(run):
    if run["kind"] != "serve" or "t" not in run["marks"]:
        return None
    t = run["marks"]["t"]
    flops = sum(work.serve_flops(run["model"], len(r["species"]))
                for r in run["records"] if r["t_done"] <= t and not r["failed"])
    return 100.0 * flops / (t - run["t0"]) / work.PEAK_F32_FLOPS
