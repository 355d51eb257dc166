"""Shared parity harness of the port's twins: the same seeded numpy inputs
through the JAX reference (on ``JAX_PLATFORMS=cpu``) and through the port,
compared with `repro_torch.testing.assert_close` at a tier of
`repro_torch.testing.tol_for`; and the reference run in a subprocess with
x64 on, for the f64 twins, so that the flag cannot leak into other tests.

``from _torch_parity import compare, reference_x64, same_inputs`` (the
tests directory is on the path, as for ``_hyp``).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch.testing import assert_close, tol_for

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

__all__ = ["same_inputs", "to_numpy", "compare", "reference_x64"]


def same_inputs(seed: int, shapes, dtype=np.float32) -> list:
    """Standard-normal numpy arrays of ``shapes``, in order, from one seeded
    generator."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in shapes]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _leaf_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_numpy(tree):
    """A tree of torch tensors or JAX arrays as numpy (bf16 widened to f32)."""
    return _map(_leaf_numpy, tree)


def compare(jax_fn, torch_fn, inputs, dtype: str = "float32", tier: str = "identity",
            cast: bool = True):
    """Run ``jax_fn`` on the inputs as JAX arrays and ``torch_fn`` on them as
    CPU tensors, and hold each output leaf of the port against the
    reference's at ``tol_for(dtype, tier)``, scale-relative.  ``inputs`` is
    a list of numpy arrays or trees of them (dicts, lists); with ``cast``
    every floating input is cast to ``dtype`` on both sides (integer inputs
    pass as they are), else all pass as they are.  Returns the two outputs
    as numpy trees (got, want)."""
    import jax.numpy as jnp

    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def floating(a):
        return cast and np.issubdtype(a.dtype, np.floating)

    def as_jax(a):
        return jnp.asarray(a, jdt) if floating(a) else jnp.asarray(a)

    def as_torch(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(tdt) if floating(a) else t

    want = to_numpy(jax_fn(*[_map(as_jax, x) for x in inputs]))
    got = to_numpy(torch_fn(*[_map(as_torch, x) for x in inputs]))
    g_leaves, w_leaves = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    tol = tol_for(dtype, tier)
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert g.shape == w.shape, (path, g.shape, w.shape)
        assert_close(g, w, tol=tol)
    return got, want


_PRELUDE = """
import os
import numpy as np
_OUT = {}


def emit(name, value):
    _OUT[name] = np.asarray(value)

"""
_EPILOGUE = """
np.savez(os.environ["PARITY_OUT"], **_OUT)
"""


def reference_x64(code: str, timeout: int = 900) -> dict:
    """Run ``code`` in a fresh interpreter with ``JAX_PLATFORMS=cpu`` and
    ``JAX_ENABLE_X64=1`` (the reference's f64 route, as
    tests/test_chain_kernel.py runs it), ``src`` on the path.  The code
    calls ``emit(name, array)`` for each output it returns, or asserts.
    Returns {name: numpy array} (read back from the ``.npy`` entries of an
    ``.npz``); a failing assertion or error fails the caller with the
    subprocess's output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        env["PARITY_OUT"] = path = os.path.join(tmp, "out.npz")
        out = subprocess.run([sys.executable, "-c", _PRELUDE + code + _EPILOGUE],
                             capture_output=True, text=True, env=env, timeout=timeout)
        assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
