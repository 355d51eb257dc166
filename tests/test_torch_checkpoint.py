"""The port's CheckpointManager against the reference's
`repro.checkpoint.manager`: round trip (bf16 included), retention and the
COMMITTED protocol, crc32 corruption detection, async save, restore onto a
device, and the file layout itself: each package restores what the other
wrote, bf16 leaves and crc32s included."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro_torch.checkpoint import CheckpointManager


def _tree():
    return {"a": torch.arange(10.0),
            "nested": {"b": torch.linspace(-2, 3, 12).reshape(3, 4).to(torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_tree_equal(got[k], w)
        else:
            assert got[k].dtype == w.dtype, k
            assert torch.equal(got[k], w), k


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(5, tree, extra={"pipeline": {"step": 7, "seed": 1}}, blocking=True)
    assert mgr.latest_step() == 5
    restored, extra = mgr.restore(5, tree)
    _assert_tree_equal(restored, tree)
    assert extra["pipeline"]["step"] == 7
    assert restored["nested"]["b"].dtype == torch.bfloat16


def test_manifest_layout(tmp_path):
    """step_N/{shard_0.npz, manifest.json, COMMITTED}; the manifest names
    shape, dtype and crc32 per leaf; bf16 is stored as uint16 bits."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(), blocking=True)
    d = tmp_path / "step_3"
    assert sorted(os.listdir(d)) == ["COMMITTED", "manifest.json", "shard_0.npz"]
    man = json.loads((d / "manifest.json").read_text())
    assert man["step"] == 3 and man["n_shards"] == 1
    assert man["entries"]["nested/b"]["dtype"] == "bfloat16"
    assert man["entries"]["nested/b"]["shape"] == [3, 4]
    assert man["entries"]["nested/step"]["dtype"] == "int32"
    with np.load(d / "shard_0.npz") as z:
        assert z["nested/b"].dtype == np.uint16
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_retention_and_commit_protocol(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.zeros(4)}
    for s in (1, 2, 3):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [2, 3]
    # uncommitted dirs are ignored
    os.makedirs(tmp_path / "step_99")
    assert mgr.latest_step() == 3


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(100.0)}
    mgr.save(1, tree, blocking=True)
    path = tmp_path / "step_1" / "shard_0.npz"
    data = dict(np.load(path))
    data["a"][0] = 999.0
    np.savez(path, **data)
    with pytest.raises(IOError):
        mgr.restore(1, tree)
    mgr.restore(1, tree, verify=False)  # the check is what raised


def test_async_save_snapshots_before_later_updates(tmp_path):
    """The save copies the leaves at call time: updating the parameter in
    place afterwards (as training does) does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    p = torch.ones(1000)
    mgr.save(1, {"p": p})
    p.add_(5.0)
    mgr.wait()
    restored, _ = mgr.restore(1, {"p": p})
    assert torch.equal(restored["p"], torch.ones(1000))


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    mgr.save(1, {"p": torch.ones(3)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_restore_places_leaves_on_device_and_target_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"w": torch.arange(16.0).reshape(4, 4)}, blocking=True)
    restored, _ = mgr.restore(2, {"w": torch.empty(4, 4, dtype=torch.float64)},
                              device="cpu")
    assert restored["w"].dtype == torch.float64 and restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], torch.arange(16.0, dtype=torch.float64).reshape(4, 4))
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(2, {"v": torch.empty(1)})


def test_reference_restores_port_checkpoint(tmp_path):
    """Same layout: the reference's manager restores (crc32s verified) what
    the port wrote, bf16 included."""
    tree = _tree()
    CheckpointManager(str(tmp_path)).save(4, tree, extra={"pipeline": {"step": 4}},
                                          blocking=True)
    target = {"a": jax.ShapeDtypeStruct((10,), jnp.float32),
              "nested": {"b": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16),
                         "step": jax.ShapeDtypeStruct((), jnp.int32)}}
    restored, extra = RefManager(str(tmp_path)).restore(4, target)
    assert extra == {"pipeline": {"step": 4}}
    np.testing.assert_array_equal(np.asarray(restored["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(restored["nested"]["b"], np.float32),
                                  tree["nested"]["b"].float().numpy())
    assert int(restored["nested"]["step"]) == 7


def test_port_restores_reference_checkpoint(tmp_path):
    ref_tree = {"a": jnp.arange(10.0),
                "nested": {"b": jnp.linspace(-2, 3, 12).reshape(3, 4).astype(jnp.bfloat16)}}
    RefManager(str(tmp_path)).save(6, ref_tree, blocking=True)
    target = {"a": torch.empty(10), "nested": {"b": torch.empty(3, 4, dtype=torch.bfloat16)}}
    restored, _ = CheckpointManager(str(tmp_path)).restore(6, target)
    assert torch.equal(restored["a"], torch.arange(10.0))
    assert restored["nested"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["nested"]["b"].float().numpy(),
                                  np.asarray(ref_tree["nested"]["b"], np.float32))
