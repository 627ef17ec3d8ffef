"""Mesh construction — the port of ``repro.launch.mesh``.

FUNCTIONS, not module-level constants: importing this module touches no
process group.  A device mesh is a ``torch.distributed`` ``DeviceMesh``
over the default process group, which the caller initialises
(``torch.distributed.init_process_group``: its backend, address, world
size and rank; nothing here guesses them).  ``AbstractMesh`` is a
device-free description of a mesh's axes, for the partition specs and the
dry-run, where the reference uses ``jax.sharding.AbstractMesh``.
"""
from __future__ import annotations

from ..device import resolve_device

__all__ = [
    "AbstractMesh",
    "MeshError",
    "make_host_mesh",
    "make_production_mesh",
]


class MeshError(RuntimeError):
    """No process group, or a world size that is not the mesh's size."""


class AbstractMesh:
    """Axis names and sizes, no devices: ``shape`` ({axis name: size}),
    ``axis_names``, ``size``."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} for axes {axis_names}")
        self.shape = dict(zip(axis_names, (int(n) for n in shape)))
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def production_shape(multi_pod: bool = False):
    """(shape, axis names): 16x16 = 256 chips per pod; 2 pods = 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _device_mesh(shape, axes, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise MeshError("no process group: call "
                        "torch.distributed.init_process_group first")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise MeshError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                        f"ranks; the process group has {world}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The 16 x 16 (or 2 x 16 x 16) ``DeviceMesh``; raises ``MeshError``
    unless the process group has 256 (512) ranks."""
    return _device_mesh(*production_shape(multi_pod), device)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A (data, model) ``DeviceMesh`` over the default process group;
    raises ``MeshError`` when none is initialised or its world size is not
    data x model."""
    return _device_mesh((data, model), ("data", "model"), device)
