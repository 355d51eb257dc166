"""serve_mfu_pct: model FLOPs of the evaluations completed before the
traced part of the window (the family's ``serve_flops`` at each molecule's
atom count; MACE: `perfbench.work.serve_flops`) over that time and
67 TFLOP/s (f32)."""
from perfbench import work


def read(run):
    if run["kind"] != "serve" or "t" not in run["marks"]:
        return None
    t, fam, cfg = run["marks"]["t"], run["family"], run["cfg"]
    flops = sum(fam.serve_flops(cfg, len(r["species"]))
                for r in run["records"] if r["t_done"] <= t and not r["failed"])
    return 100.0 * flops / (t - run["t0"]) / work.PEAK_F32_FLOPS
