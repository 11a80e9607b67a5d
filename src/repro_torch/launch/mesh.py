"""Production and host meshes.

The counterpart of ``repro/launch/mesh.py``: functions, never module
state, so that importing this module touches no process group.  Each
calls ``init_device_mesh`` on the default process group, which the caller
has set up (NCCL ranks on the cards, gloo ranks on the CPU, or the
``fake`` group of the dry run), and raises when that world is smaller
than the mesh.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "POD_SHAPE", "MULTIPOD_SHAPE"]

POD_SHAPE = (16, 16)  # 256 GPUs = 32 nodes of 8
MULTIPOD_SHAPE = (2, 16, 16)  # 2 pods = 512 GPUs


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised default process group")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n > world:
        raise ValueError(f"asked for a {'x'.join(map(str, shape))} mesh but the world has "
                         f"{world} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The (data, model) single-pod mesh or the (pod, data, model) two-pod
    mesh; ``device_type`` None is the card's (``resolve_device``)."""
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type or resolve_device(None).type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str | None = None):
    """A small (data, model) mesh over the ranks that exist (tests, local
    runs); ``device_type`` None is the card's."""
    return _mesh((data, model), ("data", "model"), device_type or resolve_device(None).type)
