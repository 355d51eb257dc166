"""Device meshes, the port of the reference's ``repro.launch.mesh``.

Functions, not module constants: importing this module touches no process
group.  A `DeviceMesh` is built over the default process group, which the
caller initializes first (``torchrun`` and `launch.train` do; the dry run
initializes a fake group of the production world size)."""
from __future__ import annotations

__all__ = ["production_shape", "make_production_mesh", "make_host_mesh"]


def production_shape(multi_pod: bool = False) -> tuple:
    """-> (shape, axis names): (16, 16) ('data', 'model') for one pod;
    (2, 16, 16) ('pod', 'data', 'model') for the 512-chip two-pod layout."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The `production_shape` mesh.  Needs a default process group of its
    world size (the dry run's fake group)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over the ranks of the default process group, on
    ``cuda`` unless ``device`` says ``cpu``.  As in the reference, ``data``
    is clipped to the world size and ``model`` to what is left; the mesh
    must then cover the whole world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs the default process group: "
                           "initialize it first (torchrun, or "
                           "torch.distributed.init_process_group)")
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh does not cover the world of {n} ranks")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
