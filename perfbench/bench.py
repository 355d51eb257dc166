"""What every cell shares: the manifest and the files found by name, the
guards, the device record, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the model's sizes and settings, its weights' init) and a traffic mix
(``traffic/<name>.json``: whose ``kind`` picks the driver, ``serve`` or
``train``, and whose parameters drive it); its limits are
``limits/<cell>.json``; each metric is read by ``metrics/<metric>.py``
(``read(run) -> number | None``).  A later cell, mix or metric is a new
file and a new manifest entry.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE_DIR = HERE / ".cache"
AUTOTUNE_CACHE = CACHE_DIR / "autotune.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["manifest", "cell", "config", "traffic", "limits", "metrics_of", "metric_reader",
           "forbidden_modules", "device_record", "emit", "fail", "finite"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, man: dict | None = None) -> dict:
    """The manifest's entry of cell ``name``."""
    for w in (man or manifest())["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(HERE / "limits" / f"{cell_name}.json")


def metrics_of(cell_name: str, trace: bool, man: dict | None = None) -> list:
    """The manifest's metrics a run of ``cell_name`` reports: end-to-end
    with ``trace`` off, per-layer with it on; a metric without
    ``workloads`` belongs to every cell."""
    man = man or manifest()
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list:
    """The top-level names among ``names`` (default: the loaded modules)
    that are, whole, jax, jaxlib, flax or the JAX package ``repro``."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def device_record(chips: int, memory_peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": memory_peak_bytes}


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def emit(result: dict, checks: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    stderr, then the result as the last line of stdout (``checks`` last)."""
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    result = dict(result, checks=checks)
    print(json.dumps(result, allow_nan=False, default=float), flush=True)


def finite(x) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)
