"""Sharded, async, integrity-checked checkpointing, after the reference's
``repro.checkpoint.manager`` (same layout and protocol).

Layout per step:
    <dir>/step_<N>/shard_<k>.npz      flat {path: array} groups, ~1 GiB each
    <dir>/step_<N>/manifest.json      paths, shapes, dtypes, crc32s, extra
                                      state (the data pipeline's)
    <dir>/step_<N>/COMMITTED          written last: restore ignores
                                      uncommitted (crashed) checkpoints

A save writes into ``.tmp_step_<N>`` and renames it into place; ``keep``
committed steps are retained.  The tree is nested dicts of tensors, such
as ``{"model": module.state_dict(), "opt": optimizer state}``; leaves are
stored under their "/"-joined paths.  A save snapshots every leaf to host
memory (a copy: training goes on updating the parameters in place), then
writes on a daemon thread; ``wait()`` joins it, and raises what it raised,
before the next save (one outstanding save, bounded memory).

``restore`` verifies every leaf's crc32 and places the leaves on one
``device``, or, given ``shardings`` (a tree of placement lists,
`distributed.sharding.param_shardings`) and a ``mesh``, lays each leaf out
as a `DTensor` on that mesh: the reference's elastic restore.  A `DTensor`
leaf saves whole (gathered: every rank takes part), and under a process
group only rank 0 writes.  numpy has no bfloat16 (the reference stores it through
``ml_dtypes``), so bf16 leaves are stored as uint16 bit patterns and
reinterpreted from the manifest's dtype on load, the reference's file
layout.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager"]

SHARD_BYTES = 1 << 30


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_storable(t: torch.Tensor) -> np.ndarray:
    """A host tensor -> the numpy array written to the shard (bf16 as its
    uint16 bit pattern, as the reference stores it)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_storable(a: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _paths(tree, prefix: str = "", leaf=lambda x: False):
    """Yield (path, leaf) over nested dicts, lists and tuples (``leaf``
    marks a list that is itself a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/", leaf)
    elif isinstance(tree, (list, tuple)) and not leaf(tree):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/", leaf)
    else:
        yield prefix[:-1], tree


def _is_placements(x) -> bool:
    """A placement list (`distributed.sharding.placements`): a leaf of a
    shardings tree."""
    from torch.distributed.tensor import Placement

    return isinstance(x, list) and all(isinstance(p, Placement) for p in x)


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or a process with none."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _rebuild(tree, leaves: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}{i}/") for i, v in enumerate(tree))
    return leaves[prefix[:-1]]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: dict | None = None, blocking: bool = False):
        """Snapshot to host, then write (asynchronously unless ``blocking``)."""
        self.wait()
        flat, dtypes = {}, {}
        for k, v in _paths(tree):
            if hasattr(v, "full_tensor"):  # a DTensor: gathered whole
                v = v.full_tensor()
            t = torch.as_tensor(v).detach().to("cpu", copy=True)  # host copy
            flat[k], dtypes[k] = _to_storable(t), _dtype_name(t)
        extra = dict(extra or {})
        if not _writer():
            return

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            shards: list[list[str]] = [[]]
            size = 0
            for k, v in flat.items():
                if size > SHARD_BYTES:
                    shards.append([])
                    size = 0
                shards[-1].append(k)
                size += v.nbytes
            manifest = {"step": step, "extra": extra, "entries": {}, "n_shards": len(shards)}
            for si, keys in enumerate(shards):
                np.savez(os.path.join(tmp, f"shard_{si}.npz"), **{k: flat[k] for k in keys})
                for k in keys:
                    manifest["entries"][k] = {"shard": si, "shape": list(flat[k].shape),
                                              "dtype": dtypes[k], "crc32": _crc(flat[k])}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except Exception as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the outstanding save; raise the error it raised, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "COMMITTED")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any, device=None, verify: bool = True,
                shardings: Any | None = None, mesh=None):
        """Restore into the structure of ``target_tree`` (its tensor leaves
        give the dtypes) on ``device`` (None: the CPU) -> (tree, extra).
        ``shardings`` (the tree's placement lists) with ``mesh`` makes each
        leaf a `DTensor` laid out on the mesh instead."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data: dict[str, np.ndarray] = {}
        for si in range(manifest["n_shards"]):
            with np.load(os.path.join(d, f"shard_{si}.npz")) as z:
                for k in z.files:
                    data[k] = z[k]
        if verify:
            for k, meta in manifest["entries"].items():
                if _crc(data[k]) != meta["crc32"]:
                    raise IOError(f"checkpoint corruption in leaf {k!r}")
        if shardings is not None:
            if mesh is None:
                raise ValueError("restore with shardings needs the mesh they lay out on")
            from torch.distributed.tensor import distribute_tensor

            dev = torch.device(mesh.device_type)
            placed = dict(_paths(shardings, leaf=_is_placements))
        else:
            dev = torch.device("cpu" if device is None else device)
        leaves = {}
        for key, proto in _paths(target_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _from_storable(data[key], manifest["entries"][key]["dtype"])
            if isinstance(proto, torch.Tensor):
                t = t.to(proto.dtype)
            t = t.to(dev)
            if shardings is not None:
                t = distribute_tensor(t, mesh, placed[key], src_data_rank=None)
            leaves[key] = t
        return _rebuild(target_tree, leaves), manifest["extra"]
