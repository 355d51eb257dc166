"""train_mfu_pct: model FLOPs of the training steps completed before the
traced part of the window (the family's ``train_flops`` a step; MACE:
`perfbench.work.train_flops`, batch x atoms) over that time and
67 TFLOP/s (f32)."""
from perfbench import work


def read(run):
    if run["kind"] != "train" or "t" not in run["marks"]:
        return None
    mk = run["marks"]
    flops = mk["steps"] * run["family"].train_flops(run["cfg"], run["mix"])
    return 100.0 * flops / (mk["t"] - run["t0"]) / work.PEAK_F32_FLOPS
