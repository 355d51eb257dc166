"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
The file name carries a hash of the source and the flags, so a changed
source rebuilds and an unchanged one loads what an earlier process built.
Nothing here runs at import time: this module is imported on machines that
have no ``nvcc`` at all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["SOURCES", "BuildResult", "build", "build_all", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"gaunt_chain": _CSRC / "gaunt_chain.cu",
           "gaunt_pair": _CSRC / "gaunt_pair.cu",
           "wkv6": _CSRC / "wkv6.cu",
           "mamba2_ssd": _CSRC / "mamba2_ssd.cu",
           "direct_conv": _CSRC / "direct_conv.cu"}
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOADED: dict[str, ctypes.CDLL] = {}


class BuildResult:
    """Where a library landed, how long nvcc took (0 when cached), and what
    ptxas reported (registers, shared memory, spills)."""

    def __init__(self, name: str, path: Path, seconds: float, log: str):
        self.name, self.path, self.seconds, self.log = name, path, seconds, log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}_{h}.so"


def build(name: str) -> BuildResult:
    """Compile ``name`` unless its library for this source is already built."""
    so = _target(name)
    if so.exists():
        return BuildResult(name, so, 0.0, "")
    t0 = time.perf_counter()
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *_FLAGS, "-o", tmp, str(SOURCES[name])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name].name}:\n{proc.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return BuildResult(name, so, time.perf_counter() - t0, proc.stdout)


def build_all() -> list[BuildResult]:
    """Build every source, one nvcc per source, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = [pool.submit(build, name) for name in SOURCES]
        return [f.result() for f in futures]


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed;
    ``declare(lib)`` sets its C signatures once, when it is loaded."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        declare(lib)
        _LOADED[name] = lib
    return lib
