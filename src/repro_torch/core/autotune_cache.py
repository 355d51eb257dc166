"""Persistent per-host autotune cache, after the reference's
``repro.core.autotune_cache``.

The measured autotuner (`core/engine.py`, ``tune='measure'``) picks each
pairwise plan's backend and each chain's backend by timing the candidates
on the device, but its table lives in-process, so every serve process
would re-time every key at startup.  This module persists the engine's
measurement stores to one versioned JSON file per host:

    selections   engine._measured    {PlanKey | chain key -> backend}
    timings      engine._measured_t  {same key -> the pick's median seconds}
    calibration  engine._CALIB       the fused-cost calibration factors

File format (schema-versioned, human-inspectable):

    {"fingerprint": {schema, framework, torch_version, cuda_version,
                     device_type, device_name, capability, device_count},
     "selections": [{"key": {"type": "plan", ...PlanKey fields...}
                            | {"type": "chain", "Ls", "Lout", "dtype",
                               "batch_hint", "share", "gate", "device"},
                     "backend": "...", "t": seconds | null}, ...],
     "calibration": {... engine.get_calibration() ...}}

Chain keys are the engine's plain tuples (`GauntEngine.chain_measure_key`:
Ls, Lout, dtype, batch_hint, share, gate, device type); plan keys are
`PlanKey`s.  Both kinds round-trip.  A chain key may carry trailing tagged
entries, written under ``"extra"``: the operands' and exit's bases
(``("entries", ...), ("out", ...)``, only when they are not all SH) and
``("gate", "policy")`` for `GauntEngine.select_gate`, whose "backend" is
'grid' or 'sh'.  A key whose dtype is 'auto' (plan or chain) names the
storage dtype that measured faster.  A file written before these keys
existed has no ``"extra"`` and loads as it did: the schema is unchanged.

Trust rules, as in the reference:

* The whole file is keyed by a hardware/software fingerprint (torch and
  CUDA versions, the device's name, compute capability and count).  Any
  mismatch invalidates the file wholesale, and a corrupt or unreadable
  file behaves the same: ``load`` returns None and the engine measures in
  process, never raising.
* Stale entries are dropped one by one on load: an unregistered backend, a
  chain backend that is not a chain flavour, a gate policy that is not
  'grid' or 'sh', an 'auto' key whose pick is not a storage dtype, an
  unknown kind or storage dtype, or a key measured on another device type
  than the fingerprint's.
* Only measurements that ran are persisted (the engine caches no failed
  measurement, and a pick pinned by `GauntEngine.pinned_chain` is not a
  measurement), so a loaded entry has a real timing behind it.
* Writes are atomic (a temporary file in the target directory, then
  ``os.replace``) and merging: a flush re-reads the file and keeps the
  entries another process persisted meanwhile (same fingerprint only);
  this process's entries win on a collision.

The engine persists only when a path is configured: ``GauntEngine(
cache_path=...)``, ``set_autotune_cache``, ``EquivariantConfig.
autotune_cache``, or the ``REPRO_TORCH_AUTOTUNE_CACHE`` environment
variable.  That variable and the default path differ from the reference's,
so a JAX process and a port process on one host never rewrite each other's
file.  Without a path every load and flush is a no-op.

Offline pre-population::

    python -m repro_torch.core.autotune_cache --cache /var/cache/gaunt_torch.json
    python -m repro_torch.core.autotune_cache --cache ... --verify-warm  # 0 runs?

sweeps the known workload grid (pairwise and conv_filter plan keys, the
benchmark chains, and the force field's many-body chain keys at every
serve bucket's rows, gated and ungated, at f32 and bf16) on the device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

__all__ = [
    "SCHEMA_VERSION",
    "ENV_VAR",
    "fingerprint",
    "default_path",
    "resolve_path",
    "load",
    "save",
    "merge_calibration",
    "main",
]

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"


def fingerprint() -> dict:
    """The hardware/software identity persisted measurements are valid for:
    the device (type, name, compute capability, count) and the software
    that produced the timed kernels (torch, CUDA)."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "schema": SCHEMA_VERSION,
        "framework": "torch",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_type": "cuda" if cuda else "cpu",
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "capability": list(torch.cuda.get_device_capability(0)) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
    }


def default_path() -> str:
    """The conventional per-user cache location (the CLI's default target)."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "repro_torch", "gaunt_autotune.json")


def resolve_path(path: str | None = None) -> str | None:
    """The effective cache path: explicit argument, else the environment
    variable, else None (persistence disabled)."""
    if path:
        return path
    return os.environ.get(ENV_VAR) or None


# --------------------------------------------------------------------------
# (de)serialization
# --------------------------------------------------------------------------


def _tuplify(v):
    """JSON round-trips tuples as lists; key hashing needs tuples back."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def _encode_key(key) -> dict:
    from .engine import PlanKey

    if isinstance(key, PlanKey):
        return {"type": "plan", **dataclasses.asdict(key)}
    Ls, Lout, dts, batch_hint, share, gate, device = key[:7]
    d = {"type": "chain", "Ls": list(Ls), "Lout": Lout, "dtype": dts,
         "batch_hint": batch_hint, "share": list(share), "gate": gate,
         "device": device}
    if len(key) > 7:
        d["extra"] = [list(e) for e in key[7:]]
    return d


def _decode_key(d: dict):
    from .engine import PlanKey

    if d["type"] == "plan":
        return PlanKey(L1=d["L1"], L2=d["L2"], Lout=d["Lout"], kind=d["kind"],
                       batch_hint=d["batch_hint"], dtype=d["dtype"],
                       extra=_tuplify(d["extra"]), device=d["device"])
    if d["type"] == "chain":
        return (_tuplify(d["Ls"]), d["Lout"], d["dtype"], d["batch_hint"],
                _tuplify(d["share"]), bool(d["gate"]), d["device"],
                *_tuplify(d.get("extra", [])))
    raise KeyError(f"unknown key type {d['type']!r}")


def _entry_valid(key, backend, device_type: str) -> bool:
    """Per-entry stale invalidation (see the module docstring)."""
    from .engine import _RDTYPE, _REGISTRY, CHAIN_BACKENDS, KINDS, PlanKey

    if not isinstance(backend, str):
        return False
    dts = key.dtype if isinstance(key, PlanKey) else key[2]
    if dts == "auto":
        picks = ("float32", "bfloat16")  # the storage dtype that won
    elif dts not in _RDTYPE:
        return False
    elif isinstance(key, PlanKey):
        picks = _REGISTRY
    elif ("gate", "policy") in key[7:]:
        picks = ("grid", "sh")
    else:
        picks = CHAIN_BACKENDS
    if isinstance(key, PlanKey):
        return key.device == device_type and key.kind in KINDS and backend in picks
    return key[6] == device_type and backend in picks


def load(path: str | None):
    """-> (selections, timings, calibration) or None.

    None means no usable cache: a missing, unreadable or corrupt file, the
    wrong schema, or a fingerprint mismatch.  Stale entries are dropped
    one by one."""
    if not path:
        return None
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    fp = fingerprint()
    if not isinstance(raw, dict) or raw.get("fingerprint") != fp:
        return None
    selections, timings = {}, {}
    for ent in raw.get("selections", ()):
        try:
            key = _decode_key(ent["key"])
            backend = ent["backend"]
        except (KeyError, TypeError, ValueError):
            continue
        if not _entry_valid(key, backend, fp["device_type"]):
            continue
        selections[key] = backend
        t = ent.get("t")
        if isinstance(t, (int, float)):
            timings[key] = float(t)
    calib = raw.get("calibration")
    return selections, timings, dict(calib) if isinstance(calib, dict) else {}


def save(path: str, selections: dict, timings: dict,
         calibration: dict | None = None, merge: bool = True) -> None:
    """Atomically persist the measurement stores to ``path``.

    With ``merge`` (the default) a valid same-fingerprint file already at
    ``path`` contributes the entries this process does not have, so
    processes flushing different keys converge instead of clobbering."""
    selections = dict(selections)
    timings = dict(timings)
    if merge:
        prev = load(path)
        if prev is not None:
            for k, b in prev[0].items():
                selections.setdefault(k, b)
            for k, t in prev[1].items():
                timings.setdefault(k, t)
    payload = {
        "fingerprint": fingerprint(),
        "selections": [
            {"key": _encode_key(k), "backend": b, "t": timings.get(k)}
            for k, b in selections.items()
        ],
    }
    if calibration is not None:
        payload["calibration"] = dict(calibration)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".gaunt_autotune.", suffix=".json", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def merge_calibration(saved: dict) -> int:
    """Fold persisted calibration into the process without clobbering
    factors this process measured itself.  Only entries the file marks
    ``*_measured`` apply: an inherited default must not pass for a
    measurement.  Returns the number of factors applied."""
    from .engine import get_calibration, set_calibration

    cur = get_calibration()
    apply = {}
    for base in [k for k in cur if not k.endswith("_measured")]:
        mk = base + "_measured"
        if saved.get(mk) and not cur.get(mk) and isinstance(saved.get(base), (int, float)):
            apply[base] = float(saved[base])
            apply[mk] = True
    if apply:
        set_calibration(**apply)
    return len(apply) // 2


# --------------------------------------------------------------------------
# offline calibrate CLI
# --------------------------------------------------------------------------


def _serve_rows() -> tuple:
    """The chain rows of the force field's default serve buckets
    (n_slots x max_atoms x channels of `default_buckets(32)`)."""
    from ..configs.gaunt_ff import gaunt_mace_ff as cfg
    from ..serve.pools import default_buckets

    return tuple(b.n_slots * b.max_atoms * cfg.channels for b in default_buckets(32))


# the sweep's pairwise degrees and chains ((Ls, Lout, rows)); --fast takes
# the first four degrees and the first three chains
_PLAN_LS = (1, 2, 3, 6, 4)
_CHAINS = (((1, 1, 1), 1, 512), ((2, 2), 2, 64), ((2, 2, 2), 2, 128),
           ((3, 3, 3), 3, 64), ((2, 2, 2, 2), 8, 256))


def _sweep(eng, fast: bool, device, serve_rows: tuple) -> int:
    """Measure the known workload grid into ``eng``'s table on ``device``,
    at both storage dtypes and the 'auto' family, with the cost model's
    calibration per dtype, so a process that loads the file boots warm
    with any ``compute_dtype`` and ``grid_gate`` -> the number of new
    selections."""
    from ..configs.gaunt_ff import gaunt_mace_ff as cfg
    from .engine import _calib_key, get_calibration

    n0 = len(eng._measured)
    dtypes = ("float32", "bfloat16", "auto")
    # the fused cost factor per storage dtype; a factor already measured
    # (here or in the loaded file) is kept: calibrate_fused always times
    for d in ("float32", "bfloat16"):
        if not get_calibration().get(_calib_key(d) + "_measured"):
            eng.calibrate_fused(dtype=d, device=device)
    for L in (_PLAN_LS[:4] if fast else _PLAN_LS):
        for B in (64, 1024):
            for d in dtypes:
                eng.plan(L, L, L, batch_hint=B, dtype=d, tune="measure",
                         requires_grad=False, device=device)
        eng.plan(L, L, L, kind="conv_filter", batch_hint=1024, tune="measure",
                 requires_grad=False, device=device)
    for Ls, Lout, B in (_CHAINS[:3] if fast else _CHAINS):
        for d in dtypes:
            eng.plan_chain(Ls, Lout, tune="measure", batch_hint=B, dtype=d, device=device)
    # the force field's many-body chain at every serve bucket's rows, the
    # keys a serve warmup seeds: ungated for grid_gate='off', gated for
    # 'on', and the gate policy that 'auto' asks for
    Ls, share = (cfg.L,) * cfg.nu, (0,) * cfg.nu
    for rows in serve_rows:
        for d in dtypes:
            for gate in (False, True):
                eng.plan_chain(Ls, cfg.L, tune="measure", batch_hint=int(rows),
                               share_hint=share, dtype=d, gate=gate, device=device)
            eng.select_gate(Ls, cfg.L, dtype=d, batch_hint=int(rows), share_hint=share,
                            device=device)
    return len(eng._measured) - n0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.autotune_cache",
        description="Offline autotune calibration: sweep the known workload grid "
                    "on the device and persist the measured selection table so "
                    "serve processes boot warm.")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default: ${ENV_VAR} or {default_path()})")
    ap.add_argument("--fast", action="store_true", help="smaller sweep")
    ap.add_argument("--serve-rows", default=None,
                    help="comma-separated serve chain row counts (n_slots x "
                         "max_atoms x channels per bucket; default: the rows of "
                         "default_buckets(32) at gaunt_mace_ff)")
    ap.add_argument("--device", default="cuda",
                    help="device to measure on (default cuda; 'cpu' times the "
                         "plain backends on the host)")
    ap.add_argument("--verify-warm", action="store_true",
                    help="re-run the sweep and FAIL (exit 2) if any timing run "
                         "happened: proves the cache file covers the grid")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from .engine import get_engine

    device = resolve_device(args.device)
    path = resolve_path(args.cache) or default_path()
    eng = get_engine()
    eng.set_autotune_cache(path)
    loaded = eng.load_autotune_cache()
    rows = (tuple(int(r) for r in args.serve_rows.split(",") if r)
            if args.serve_rows else _serve_rows())
    new = _sweep(eng, fast=args.fast, device=device, serve_rows=rows)
    eng.flush_autotune_cache()
    print(f"cache: {path}")
    print(f"loaded {loaded} persisted selections; measured {new} new; "
          f"{eng.timing_runs} timing runs this process")
    if args.verify_warm and eng.timing_runs > 0:
        print(f"VERIFY-WARM FAILED: {eng.timing_runs} timing runs: the cache did "
              "not cover the sweep (another fingerprint? a partial file?)")
        return 2
    if args.verify_warm:
        print("verify-warm OK: zero timing runs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
