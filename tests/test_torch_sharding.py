"""The port's partitioning rules and dry run against the reference's —
twins of tests/test_sharding_properties.py (hypothesis, as the reference)
and of tests/test_system.py::test_dryrun_tiny_cell_subprocess — plus the
placements of every parameter leaf of all ten language models under the
three layouts on both production meshes, and their batch and cache
layouts, equal to the reference's specs.

The rules need no process group: they take a `MeshShape` (names and
sizes).  The reference's are called with a stand-in mesh object that has
``axis_names`` and ``devices.shape``, so no 256 devices are needed; its
``batch_shardings`` and ``cache_shardings`` wrap each spec in a
``NamedSharding``, which the test replaces by the bare spec."""
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis, or clean skips when absent

import repro.distributed.sharding as ref_sharding
from repro.config import SHAPES as REF_SHAPES
from repro.config import get_config as ref_get_config
from repro.configs import ALL_LM_ARCHS
from repro.models import build_model as ref_build_model
from repro.models import input_specs as ref_input_specs
from repro_torch.config import SHAPES, get_config
from repro_torch.distributed.collectives import _quant
from repro_torch.distributed.sharding import (MeshShape, batch_pspec, batch_shardings,
                                              cache_pspec, cache_shardings, choose_pspec,
                                              param_pspec, placements, rule_key)
from repro_torch.models import transformer as T
from repro_torch.models.api import input_specs

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MESH = MeshShape(("data", "model"), (4, 2))
PRODUCTION = {"16x16": (("data", "model"), (16, 16)),
              "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
LAYOUTS = ("default", "dp_heavy", "moe_expert_tp")


def _stand_in(names, shape):
    """What the reference's rules read of a jax Mesh."""
    return types.SimpleNamespace(axis_names=tuple(names), devices=np.empty(shape))


def _walk(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}.{k}" if path else k)
    else:
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}.{i}" if path else str(i))


def _ref_leaves(tree):
    return {ref_sharding._leaf_key(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------------------
# twins of tests/test_sharding_properties.py
# --------------------------------------------------------------------------


@given(
    st.lists(st.sampled_from([1, 2, 3, 8, 16, 60, 64, 128, 896, 6144]),
             min_size=1, max_size=4),
    st.lists(st.lists(st.sampled_from(["data", "model", "bogus"]), max_size=2),
             max_size=4),
)
@settings(max_examples=50, deadline=None)
def test_choose_pspec_always_valid(shape, prefs):
    """Any shape x any preference list -> a spec whose sharded dims divide,
    the same as the reference's."""
    spec = choose_pspec(tuple(shape), MESH, prefs)
    assert len(spec) == len(shape)
    used = [a for a in spec if a is not None]
    assert len(used) == len(set(used))  # no axis reuse
    sizes = dict(zip(MESH.axis_names, MESH.shape))
    for dim, ax in zip(shape, spec):
        if ax is not None:
            assert dim % sizes[ax] == 0
    assert spec == tuple(ref_sharding.choose_pspec(tuple(shape),
                                                   _stand_in(MESH.axis_names, MESH.shape), prefs))


@given(
    st.sampled_from([
        "layers.0.attn.wq.w", "layers.3.mlp.w_down.w", "layers.1.moe.we_gate",
        "embed.embedding", "unembed.w", "mamba.5.m.in_proj.w", "layers.2.tm.wo.w",
        "cat_proj.w", "layers.0.ln1.scale", "shared.attn.wk.b",
    ]),
    st.lists(st.sampled_from([1, 2, 16, 64, 128, 896, 2048, 50304]),
             min_size=1, max_size=4),
    st.sampled_from(LAYOUTS),
)
@settings(max_examples=80, deadline=None)
def test_param_pspec_valid_for_any_leaf(key, shape, layout):
    spec = param_pspec(key, tuple(shape), MESH, layout)
    assert len(spec) == len(shape)
    sizes = dict(zip(MESH.axis_names, MESH.shape))
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        assert dim % math.prod(sizes[a] for a in axes) == 0, (key, shape, spec)
    pl = placements(spec, MESH)
    assert len(pl) == 2 and all(p.is_replicate() or p.is_shard() for p in pl)


@given(st.integers(1, 8), st.integers(1, 1024))
@settings(max_examples=30, deadline=None)
def test_batch_shardings_never_invalid(b, s):
    tree = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    sh = batch_shardings(tree, MESH)
    assert set(sh) == {"tokens"} and len(sh["tokens"]) == 2
    if b % 4 == 0:
        assert sh["tokens"][0].is_shard() and sh["tokens"][0].dim == 0
    else:
        assert all(p.is_replicate() for p in sh["tokens"])


@given(
    st.integers(1, 4),    # layers
    st.sampled_from([1, 2, 8, 128]),   # batch
    st.sampled_from([64, 4096, 32768]),  # seq
    st.sampled_from([1, 2, 8, 40]),   # kv heads
)
@settings(max_examples=30, deadline=None)
def test_cache_shardings_structural(L, B, S, KV):
    tree = {"k": torch.empty((L, B, S, KV, 64), dtype=torch.float16, device="meta")}
    spec = cache_pspec(tuple(tree["k"].shape), MESH)
    assert len(spec) == 5
    # never shards the layer or head-dim axes
    assert spec[0] is None and spec[4] is None
    assert len(cache_shardings(tree, MESH)["k"]) == 2


def test_int8_ef_compression_roundtrip_unbiased():
    """Error-feedback compression: the mean over steps converges to the
    true mean."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(64,)) * 3.0, dtype=torch.float32)
    e = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    steps = 50
    for _ in range(steps):
        q, scale = _quant(x + e)
        deq = q.float() * scale
        e = (x + e) - deq
        acc = acc + deq
    np.testing.assert_allclose((acc / steps).numpy(), x.numpy(), atol=0.05, rtol=0.02)


# --------------------------------------------------------------------------
# every leaf of all ten LM configs against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("names,shape", list(PRODUCTION.values()))
def test_row_helpers_match_reference(names, shape):
    """dp_axes, dp_size and row_pspec (the engine's row layout) as the
    reference's, and row_sharding's placements shard dim 0 over them."""
    from repro_torch.distributed.sharding import dp_axes, dp_size, row_pspec, row_sharding

    mesh, stand_in = MeshShape(names, shape), _stand_in(names, shape)
    dp = dp_axes(mesh)
    assert dp == ref_sharding.dp_axes(stand_in)
    assert dp_size(mesh) == ref_sharding.dp_size(stand_in)
    for ndim in (1, 2, 3):
        assert row_pspec(ndim, dp) == tuple(ref_sharding.row_pspec(ndim, dp))
        pl = row_sharding(mesh, ndim)
        assert [p.is_shard() and p.dim == 0 for p in pl] == [a in dp for a in names]


def test_rule_key_drops_the_layer_index():
    assert rule_key("layers.12.attn.wq.w") == "layers/attn/wq/w"
    assert rule_key("mamba.0.m.conv_w") == "mamba/m/conv_w"
    assert rule_key("embed.embedding") == "embed/embedding"


@pytest.mark.parametrize("arch", ALL_LM_ARCHS)
def test_param_placements_match_reference_every_leaf(arch):
    """Each of the port's per-layer leaves gets the reference's spec of its
    stacked leaf without the leading scan axis, for the three layouts on
    both production meshes; the placements shard exactly those dims."""
    ref = _ref_leaves(jax.eval_shape(
        lambda: ref_build_model(ref_get_config(arch)).init(jax.random.PRNGKey(0))))
    port = dict(_walk(T.init_params(None, get_config(arch), torch.device("meta"))))
    assert {rule_key(k) for k in port} == set(ref)
    for names, shape in PRODUCTION.values():
        mesh, stand_in = MeshShape(names, shape), _stand_in(names, shape)
        for layout in LAYOUTS:
            for k, leaf in port.items():
                rk = rule_key(k)
                want = tuple(ref_sharding.param_pspec(rk, ref[rk].shape, stand_in, layout))
                if rk.startswith(ref_sharding._STACK_PREFIXES):
                    assert want[0] is None
                    want = want[1:]
                got = param_pspec(k, tuple(leaf.shape), mesh, layout)
                assert got == want, (arch, layout, shape, k, got, want)
                pl = placements(got, mesh)
                for a, p in zip(names, pl):
                    dims = [d for d, e in enumerate(got)
                            if e == a or (isinstance(e, tuple) and a in e)]
                    assert (p.is_shard() and [p.dim] == dims) or (p.is_replicate()
                                                                 and not dims)


@pytest.mark.parametrize("arch", ALL_LM_ARCHS)
def test_batch_and_cache_layouts_match_reference(arch, monkeypatch):
    """The train batch, the decode batch and every cache leaf of each arch
    on both production meshes: the reference's specs."""
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)
    for names, shape in PRODUCTION.values():
        mesh, stand_in = MeshShape(names, shape), _stand_in(names, shape)
        for sname in ("train_4k", "decode_32k"):
            ours = input_specs(get_config(arch), SHAPES[sname])
            ref = ref_input_specs(ref_get_config(arch), REF_SHAPES[sname])
            if sname == "decode_32k":
                want = ref_sharding.cache_shardings(ref["cache"], stand_in)
                got = dict(_walk(ours["cache"]))
                flat = jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
                want = {".".join(str(getattr(p, "key", p)) for p in path): tuple(s)
                        for path, s in flat}
                assert set(got) == set(want)
                for k, leaf in got.items():
                    assert cache_pspec(tuple(leaf.shape), mesh) == want[k], (arch, k)
                ours = {k: ours[k] for k in ("tokens", "pos")}
                ref = {k: ref[k] for k in ("tokens", "pos")}
            want = ref_sharding.batch_shardings(ref, stand_in)
            for k, leaf in ours.items():
                assert batch_pspec(tuple(leaf.shape), mesh) == tuple(want[k]), (arch, k)


# --------------------------------------------------------------------------
# the dry run (twin of tests/test_system.py::test_dryrun_tiny_cell_subprocess)
# --------------------------------------------------------------------------


def test_dryrun_tiny_cell_subprocess():
    """Two tiny cells on a (4, 2) and a (2, 2, 2) fake mesh, in a subprocess
    (the fake process group stays out of this one): status ok, FLOPs per
    device > 0, the parameter bytes per device those the reference's specs
    give on the same mesh, and the whole weights the step gathers at once
    (every leaf outside the layer stack and one layer, twice in training)
    from the reference's shapes, counted in the peak."""
    code = (
        "import json, repro_torch.launch.mesh as M\n"
        "M.production_shape = lambda multi_pod=False: ((2, 2, 2), ('pod', 'data', 'model')) "
        "if multi_pod else ((4, 2), ('data', 'model'))\n"
        "from repro_torch.launch.dryrun import dryrun_cell\n"
        "r1 = dryrun_cell('qwen2-0.5b', 'train_4k', False, tiny=True)\n"
        "r2 = dryrun_cell('qwen2-0.5b', 'decode_32k', True, tiny=True)\n"
        "print('RECORDS', json.dumps([r1, r2]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r1, r2 = __import__("json").loads(out.stdout.split("RECORDS", 1)[1])
    assert r1["status"] == "ok" and r2["status"] == "ok", (r1, r2)
    assert (r1["mesh"], r2["mesh"]) == ("4x2", "2x2x2")
    for r in (r1, r2):
        assert r["cost"]["flops_per_device"] > 0
        assert r["collectives"]["total_bytes"] > 0
        assert r["memory"]["temp_bytes"] is None
    assert r1["collectives"]["by_kind"]["reduce-scatter"] > 0
    assert r1["memory"]["optimizer_bytes"] == 2 * r1["memory"]["param_bytes"]
    ref = _ref_leaves(jax.eval_shape(
        lambda: ref_build_model(ref_get_config("qwen2-0.5b").reduced()).init(
            jax.random.PRNGKey(0))))
    for r, (names, shape) in ((r1, (("data", "model"), (4, 2))),
                              (r2, (("pod", "data", "model"), (2, 2, 2)))):
        sizes = dict(zip(names, shape))
        want = 0
        for k, leaf in ref.items():
            spec = ref_sharding.param_pspec(k, leaf.shape, _stand_in(names, shape))
            split = math.prod(sizes[a] for e in spec if e is not None
                              for a in (e if isinstance(e, tuple) else (e,)))
            want += math.prod(leaf.shape) // split * np.dtype(leaf.dtype).itemsize
        assert r["memory"]["param_bytes"] == want, (r["mesh"], r["memory"], want)
    # what the step holds whole at once: everything outside the layer stack,
    # plus one layer (train: its weights and their whole gradients)
    n_layers = ref_get_config("qwen2-0.5b").reduced().n_layers
    whole = {k: math.prod(x.shape) * np.dtype(x.dtype).itemsize for k, x in ref.items()}
    root = sum(b for k, b in whole.items() if not k.startswith("layers/"))
    layer = sum(b for k, b in whole.items() if k.startswith("layers/")) // n_layers
    assert r1["memory"]["gathered_bytes"] == root + 2 * layer
    assert r2["memory"]["gathered_bytes"] == root + layer
    m = r1["memory"]
    assert m["peak_per_device_gb"] == round(
        (m["argument_bytes"] + m["grad_bytes"] + m["gathered_bytes"]) / 2**30, 3)
