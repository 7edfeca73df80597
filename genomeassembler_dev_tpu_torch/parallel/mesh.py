"""Device meshes for the framework's parallel axes (mirrors
genomeassembler_dev_tpu/parallel/mesh.py), on torch.distributed.

  seg  — data parallelism over independent segments/experiments,
  read — read-batch parallelism within one segment: reads sharded, k-mer
         counts and break-score partials summed over the axis,
  tp   — tensor/table parallelism: the probability table or the model's
         hidden dimension sharded, partial dots summed over the axis.

One real difference from JAX: there one process drives all of its host's
devices and a sharded array is one global object; here one process (rank)
drives one device. A mesh is a `DeviceMesh` of ranks shaped (seg, read, tp),
every rank calls the same step on the same global inputs, takes its own
block of each sharded dimension (`block`), and runs the collectives over the
axis groups. Outputs are the rank's block; `gather` assembles the global one
on request. The helpers also take a sub-mesh without some axes (e.g.
`mesh["read", "tp"]`): a missing axis has size 1.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("seg", "read", "tp")


def make_mesh(seg: int | None = None, read: int = 1, tp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh with axes (seg, read, tp) over the first seg*read*tp ranks of
    the initialised process group. With seg=None all ranks go to it. Every
    rank of the group must call this, members or not (it creates the axis
    groups); a rank outside the mesh gets coordinate None."""
    n = dist.get_world_size()
    if seg is None:
        if n % (read * tp):
            raise ValueError(f"{n} ranks not divisible by read*tp={read * tp}")
        seg = n // (read * tp)
    size = seg * read * tp
    if size > n:
        raise ValueError(f"mesh {seg}x{read}x{tp} needs more than {n} ranks")
    if size == n:
        return init_device_mesh(device_type, (seg, read, tp), mesh_dim_names=AXES)
    return DeviceMesh(device_type, torch.arange(size).view(seg, read, tp), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of `axis`, or None where the axis has one rank and
    collectives over it are no-ops."""
    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axes: str | tuple[str, ...],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of t over a mesh axis, or over several axes one
    after another (the same reduction over their product); returns t."""
    for axis in (axes,) if isinstance(axes, str) else axes:
        group = axis_group(mesh, axis)
        if group is not None:
            dist.all_reduce(t, op=op, group=group)
    return t


def block(n: int, mesh: DeviceMesh, axis: str) -> slice:
    """This rank's contiguous block of a dimension of length n sharded over
    `axis`, as NamedSharding splits it; n must divide by the axis size."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"dimension {n} not divisible by the {axis} axis ({size})")
    per = n // size
    i = axis_index(mesh, axis)
    return slice(i * per, (i + 1) * per)


def gather(x: torch.Tensor, mesh: DeviceMesh, axis: str = "seg", dim: int = 0) -> torch.Tensor:
    """The global tensor from each rank's block along `dim`, sharded over
    `axis`: an all-gather over the axis group, blocks in axis order."""
    group = axis_group(mesh, axis)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
