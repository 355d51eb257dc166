"""What every cell shares: the manifest and the files found by name, the
guards, the device record, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
its ``family``, the model's sizes and settings, its weights' init) and a
traffic mix (``traffic/<name>.json``: whose ``kind`` names the run kind's
module, ``<kind>.py``, and whose parameters drive it); its limits are
``limits/<cell>.json``; each metric is read by ``metrics/<metric>.py``
(``read(run) -> number | None``).  A configuration's ``family`` names
``families/<family>.py``: everything that belongs to one model (its
weights, the port's model, its plain reference, its inputs, its counts of
work), which the run kinds call and never name.  A later configuration,
family, run kind, mix or metric is a new file and a new manifest entry.

Each file is looked up under the directories of `ROOTS` in order (the
package's own directory; tests put another before it).
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
ROOTS = [HERE]
CACHE_DIR = HERE / ".cache"
AUTOTUNE_CACHE = CACHE_DIR / "autotune.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["manifest", "cell", "config", "traffic", "limits", "family", "kind",
           "metrics_of", "metric_reader", "port_spans", "forbidden_modules", "device_record",
           "emit", "fail", "finite"]

# what every family gives; each run kind lists what else it calls (``FAMILY``)
FAMILY = ("make_weights", "build", "reference")


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


def _found(sub: str, name: str, suffix: str = ".json") -> Path:
    """``<root>/<sub>/<name><suffix>`` under the first of `ROOTS` that has
    it; a name found nowhere stops the run, naming it."""
    for root in ROOTS:
        path = root / sub / f"{name}{suffix}"
        if path.is_file():
            return path
    raise SystemExit(f"perfbench: no {sub}/{name}{suffix} under "
                     f"{', '.join(map(str, ROOTS))}")


def config(name: str) -> dict:
    return _json(_found("configs", name))


def traffic(name: str) -> dict:
    return _json(_found("traffic", name))


def limits(cell_name: str) -> dict:
    return _json(_found("limits", cell_name))


def _from_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(path: Path, sub: str, name: str):
    """The module of ``path`` (``<root>/<sub>/<name>.py``): the package's
    own imported as such, another root's loaded from its file."""
    dotted = name if sub == "." else f"{sub}.{name}"
    if path.parent.resolve() == (HERE / sub).resolve():
        return importlib.import_module(f"perfbench.{dotted}")
    return _from_file(path, "perfbench_" + dotted.replace(".", "_"))


def family(name: str):
    """The module ``families/<name>.py``: one model's weights, port model,
    plain reference, inputs and counts of work."""
    return _module(_found("families", name, ".py"), "families", name)


def kind(name: str):
    """The module ``<name>.py`` that drives a traffic mix of kind ``name``
    (its ``run``, and ``FAMILY``: what it calls of a family)."""
    mod = _module(_found(".", name, ".py"), ".", name)
    if not hasattr(mod, "run") or not hasattr(mod, "FAMILY"):
        raise SystemExit(f"perfbench: {name}.py is no run kind (no run and FAMILY)")
    return mod


def metrics_of(cell_name: str, trace: bool, man: dict | None = None) -> list:
    """The manifest's metrics a run of ``cell_name`` reports: end-to-end
    with ``trace`` off, per-layer with it on; a metric without
    ``workloads`` belongs to every cell."""
    man = man or manifest()
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = _found("metrics", name, ".py")
    return _from_file(path, "perfbench_metric_" + name.replace(".", "_")).read


def port_spans():
    """The port's span module (`repro_torch.spans`), or None where the
    program has none."""
    if importlib.util.find_spec("repro_torch.spans") is None:
        return None
    return importlib.import_module("repro_torch.spans")


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
