"""Mesh helpers: the layout of the ranks (port of
``sview_fmindex_tpu.parallel.mesh``).

A mesh names the axes of the rank grid: ``dp`` (pattern batches split along
it; the index whole on every rank), ``rs`` (the big tables split along it by
block range), or the 2-D ``(rs, dp)``.  It is a ``DeviceMesh`` of
``torch.distributed`` plus this rank's device; each axis has a process group
of the ranks that differ only in that coordinate.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import distributed

DP_AXIS = "dp"
RS_AXIS = "rs"


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The rank grid, seen from this rank.  Sizes, coordinates and groups
    are read off the ``DeviceMesh`` once: queries ask for them on every call."""

    device_mesh: DeviceMesh
    device: torch.device
    axis_names: tuple
    sizes: dict
    coords: dict
    groups: dict

    @classmethod
    def of(cls, dm: DeviceMesh, device: torch.device) -> "RankMesh":
        names = tuple(dm.mesh_dim_names)
        return cls(device_mesh=dm, device=device, axis_names=names,
                   sizes={a: dm.size(i) for i, a in enumerate(names)},
                   coords={a: dm.get_local_rank(a) for a in names},
                   groups={a: dm.get_group(a) for a in names})

    @property
    def n_ranks(self) -> int:
        return self.device_mesh.mesh.numel()

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of the ranks that share every other coordinate."""
        return self.groups[axis]


def make_mesh(n_devices: int | None = None, axis: str = DP_AXIS, *,
              shape: tuple | None = None, axes: tuple | None = None) -> RankMesh:
    """Mesh over every rank of the initialised group: 1-D along ``axis``
    (``"dp"`` or ``"rs"``), or ``shape`` with ``axes`` names, e.g. ``(2, 2)``
    and ``("rs", "dp")`` (row-major: rank = rs * dp_size + dp).

    A process is one device, so the mesh always spans the whole group;
    ``n_devices``, where given, must equal its size.
    """
    rt = distributed.runtime()
    world = dist.get_world_size()
    if shape is None:
        shape, axes = (world,), (axis,)
    if axes is None or len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} needs one axis name per dim, got {axes}")
    n = 1
    for s in shape:
        n *= s
    if n != world or (n_devices is not None and n_devices != world):
        raise ValueError(
            f"a mesh spans the whole group of {world} ranks; got shape {shape}"
            + (f" and n_devices={n_devices}" if n_devices is not None else ""))
    # the groups run where the collectives run: gloo's on host tensors
    dm = init_device_mesh("cuda" if rt.backend == "nccl" else "cpu", tuple(shape),
                          mesh_dim_names=tuple(axes))
    mesh = RankMesh.of(dm, rt.device)
    for group in mesh.groups.values():
        # subgroups are born with the backend's default timeout, not the
        # group's: give each the runtime's, so a lost rank fails its peers
        distributed_c10d._set_pg_timeout(rt.timeout, group)
    return mesh
