"""Readings that a cell's limits are set from, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... --seconds 3 \
        [--control-seeds 1,2,3]

For each seed: one run of the cell as ``run.py`` makes it (a short window),
and the numbers its check compares (the lower readings).  For each control
seed: the same comparison with the reference itself in the program's place,
computed in float32 with TF32 matrix products, the nearest precision below
the program's float32 with TF32 off (the upper readings); for the training
cell also the reference fed half of each batch, the mean over the rest, in
the program's place (a fault).  One JSON line per reading, then the
largest lower and the smallest upper reading of each number.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, check  # noqa: E402
from perfbench.run import run_cell  # noqa: E402


def control_serve(family, cfg, rec, seed, device):
    sample = check.sample_requests(rec["records"], seed)
    wts = family.make_weights(cfg, seed, device)
    return {"tf32": check.control_serve(family, cfg, wts, sample, device)}


def control_train(family, cfg, mix, seed, device):
    import torch

    from perfbench.train import adamw_settings
    from repro_torch.config import TrainConfig

    opt = adamw_settings(TrainConfig(**mix["optimizer"]))
    w0 = family.make_weights(cfg, seed, device)
    batch = family.batches(mix, seed)
    batches = [{k: torch.as_tensor(v) for k, v in batch(j).items()}
               for j in range(mix["check_steps"])]
    return check.control_train(family, cfg, w0, batches, opt, mix, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        bench.fail("needs a CUDA device", 3)
    bench.CACHE_DIR.mkdir(parents=True, exist_ok=True)
    # the port's measured chain picks persist here, for serving and training
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(bench.AUTOTUNE_CACHE)
    man = bench.manifest()
    c = bench.cell(a.workload, man)
    cfg, mix = bench.config(c["config"]), bench.traffic(c["traffic"])
    family = bench.family(cfg["family"])
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    lower: dict = {}
    upper: dict = {}
    for s in seeds:
        # each run's engine, graphs and reference leave cached blocks behind;
        # one process holding a dozen runs' worth fails a later capture
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res, checks, rec = run_cell(a.workload, s, a.seconds, False, "cuda", t0, man)
        vals = {k: v["value"] for k, v in checks.items()}
        for k, v in vals.items():
            lower[k] = max(lower.get(k, 0.0), v)
        print(json.dumps({"seed": s, "program": vals, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "setup_s": rec["setup_s"]}), flush=True)
        if s in controls:
            ctl = (control_serve(family, cfg, rec, s, "cuda") if rec["kind"] == "serve"
                   else control_train(family, cfg, mix, s, "cuda"))
            for kind, r in ctl.items():
                for k, v in r.items():
                    upper.setdefault(kind, {})[k] = min(upper.get(kind, {}).get(k, 1e9), v)
                print(json.dumps({"seed": s, kind: r}), flush=True)
    print(json.dumps({"lower": lower, "upper": upper, "seeds": len(seeds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
