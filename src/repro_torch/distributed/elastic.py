"""Elastic scaling: move a training state between meshes of another shape
or size, the port of the reference's ``repro.distributed.elastic``.

Checkpoints are mesh-agnostic (whole tensors on the host); restoring with
the new mesh's placements lays every leaf out there (`CheckpointManager`).
`reshard_tree` moves a live tree with no disk round trip.
"""
from __future__ import annotations

from .sharding import param_shardings

__all__ = ["reshard_tree", "restore_on_mesh"]


def reshard_tree(tree, new_mesh, layout: str = "default"):
    """Re-place a live tree (nested dicts and lists of tensors or DTensors)
    onto ``new_mesh`` by the parameter rules -> the tree of DTensors.
    Every rank must hold the same values of a plain leaf; a DTensor leaf is
    gathered whole first."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = param_shardings(tree, new_mesh, layout=layout)

    def move(x, pl):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return distribute_tensor(x.detach().to(new_mesh.device_type), new_mesh, pl,
                                 src_data_rank=None)

    def walk(x, pl):
        if isinstance(x, dict):
            return {k: walk(v, pl[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, p) for v, p in zip(x, pl))
        return move(x, pl)

    return walk(tree, placements)


def restore_on_mesh(manager, step: int, target_tree, new_mesh, layout: str = "default"):
    """Restore checkpoint ``step`` straight onto a (possibly different) mesh
    -> (tree of DTensors, extra)."""
    sh = param_shardings(target_tree, new_mesh, layout=layout)
    return manager.restore(step, target_tree, shardings=sh, mesh=new_mesh)
