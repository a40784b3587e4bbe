"""Meshes: a plain description any code can build, and a
``torch.distributed`` device mesh over the ranks of a running group.

The counterpart of ``repro.launch.mesh``.  The reference's
``make_production_mesh`` builds a JAX mesh over 256 (16 x 16, "data" x
"model") or 512 (2 x 16 x 16, with "pod") TPU chips; here
``production_mesh`` describes that layout (``MeshSpec``: shape and axis
names, no ranks needed), which ``launch.specs`` reads to give each rank's
shard shapes, and ``make_mesh`` builds a
``torch.distributed.device_mesh.DeviceMesh`` over an initialized process
group whose world size is the product of the shape.  ``data_axes_of``
takes either.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's layout: its shape and the name of each axis."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """(16, 16) ("data", "model") for one pod; (2, 16, 16) ("pod", "data",
    "model") for two, the reference's production layouts."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``axes`` over the ranks of
    the initialized default group, whose world size must be the product
    of the shape."""
    from torch.distributed.device_mesh import init_device_mesh
    spec = MeshSpec(tuple(shape), tuple(axes))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group")
    if dist.get_world_size() != spec.size:
        raise ValueError(f"mesh {spec.shape} holds {spec.size} ranks, the "
                         f"group {dist.get_world_size()}")
    return init_device_mesh(device_type, spec.shape,
                            mesh_dim_names=spec.axis_names)


def axis_names(mesh) -> tuple[str, ...]:
    """A ``MeshSpec``'s or a ``DeviceMesh``'s axis names."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``MeshSpec`` or a ``DeviceMesh``."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def data_axes_of(mesh) -> tuple[str, ...]:
    """Every axis but "model" is a data axis ("pod" included)."""
    return tuple(a for a in axis_names(mesh) if a != "model")
