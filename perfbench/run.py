"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
stdout: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; each compared
number beside its limit goes last, there under ``checks`` and on stderr.

Without a CUDA device, or with fewer than the cell asks for, it exits
non-zero and prints no result; so it does if a module of JAX or of the
JAX package ``repro`` is loaded once the window has closed.  Kernel builds
stay in the checkout (``build/kernels``), the chain autotune cache at
``perfbench/.cache/autotune.json``.  With ``--trace 1`` the port's spans
are on (``REPRO_TORCH_SPANS=1``, set before the port is imported), with
``--trace 0`` off.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# one host thread for PyTorch's CPU work: the steps are paced by the host's
# launches, and idle pool threads spinning beside them only add noise
os.environ.setdefault("OMP_NUM_THREADS", "1")

from perfbench import bench  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, man: dict | None = None, **kw):
    """(result fields, checks, run record) of one run of cell ``name``: the
    run kind of its traffic on its configuration's ``family``;
    ``kw`` goes to the driver (tests)."""
    man = man or bench.manifest()
    c = bench.cell(name, man)
    cfg, mix, lim = bench.config(c["config"]), bench.traffic(c["traffic"]), bench.limits(name)
    family, kind = bench.family(cfg["family"]), bench.kind(mix["kind"])
    return kind.run(c, cfg, family, mix, lim, seed, seconds, trace, device, t_start, **kw)


def read_metrics(name: str, trace: bool, rec: dict, man: dict) -> dict:
    """Every metric of the cell that its reader finds something for."""
    out = {}
    for m in bench.metrics_of(name, trace, man):
        v = bench.metric_reader(m["name"])(rec)
        if bench.finite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    # the port reads this once, where its span module is imported
    os.environ["REPRO_TORCH_SPANS"] = "1" if args.trace else "0"
    man = bench.manifest()
    c = bench.cell(args.workload, man)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        bench.fail(f"needs {c['chips']} CUDA device(s), found "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    bench.CACHE_DIR.mkdir(parents=True, exist_ok=True)
    # the port's measured chain picks persist here, for serving and training
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(bench.AUTOTUNE_CACHE)
    result, checks, rec = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                   "cuda", T_START, man)
    bad = bench.forbidden_modules()
    if bad:
        bench.fail(f"modules of JAX or of the JAX package loaded: {bad}", 4)
    result["metrics"] = read_metrics(args.workload, bool(args.trace), rec, man)
    dev = bench.device_record(c["chips"], rec["memory_peak_bytes"])
    if args.trace:
        tr = rec["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["device"] = dev
    bench.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
