"""Mesh construction (port of `repro/launch/mesh.py`).

FUNCTIONS (not module-level constants), so importing this module touches
no process group.  A mesh is a `torch.distributed.device_mesh.DeviceMesh`
over the default process group, which the caller initializes first
(`torch.distributed.init_process_group` with an explicit address, world
size and rank); the mesh takes the group's first ``prod(shape)`` ranks.

Single pod:  (16, 16)        axes ("data", "model")        — 256 ranks
Multi-pod:   (2, 16, 16)     axes ("pod", "data", "model") — 512 ranks

The "pod" axis composes with "data" for gradient reduction (batch is
sharded over ("pod", "data")); "model" carries tensor/expert parallelism.
A process group with fewer ranks than a mesh needs raises, naming both
counts.  The production meshes need 256 or 512 ranks: a step is traced on
them as rank 0 of a fake world (`fake_world`, over the fake process group
of `torch.testing._internal`, not a public API), where collectives move no
data, on a mesh that describes the card without touching it
(``abstract=True``).

`flat_view` merges "pod" and "data" into one mesh dimension of 32: a
plain `DeviceMesh` of shape (32, 16) over the same ranks at the same
coordinates (rank r is (r // 256, r // 16 % 16, r % 16) on the 3-D mesh and
(r // 16, r % 16) on the merged one), whose merged dimension's axes and
sizes are recorded (`parallel.sharding.merge_dim`, keyed by the dimension's
name and size, not by the mesh object), so `data_axes`, `model_axis`, the
rules and their specs read it as the 3-D mesh.  DTensor shards a tensor
dimension over several mesh dimensions in mesh order, "pod" major, so a
dimension sharded over the merged one gives each rank the same slice, and
a collective over ("pod", "data") is one collective over its 32 ranks, as
in XLA's one replica group.  Its planner then searches two mesh dimensions,
as on the single pod, where on three it took minutes an op.  It uses the
public `DeviceMesh` constructor only (not the private
`DeviceMesh._flatten`); checked with torch 2.13 (CPU) and 2.11 (CUDA).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import POD_DATA, merge_dim, mesh_axes, mesh_axis_names

__all__ = ["data_axes", "fake_world", "flat_view", "make_mesh", "make_production_mesh",
           "mesh_context", "model_axis"]


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None,
                         abstract: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device, abstract=abstract)


def _check_world(n: int, shape) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {tuple(shape)} needs a process group of {n} ranks; "
                           f"none is initialized")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks; the process group has "
                           f"{world}")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device: DeviceLike = None, *,
              abstract: bool = False) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` on ``device`` (``None``: the card,
    which becomes the process's current CUDA device) over the first
    ``prod(shape)`` ranks of the default process group.  ``abstract=True``
    describes ``device`` without touching it, for a step traced on the meta
    device (`launch.build`)."""
    n = math.prod(shape)
    _check_world(n, shape)
    if abstract:
        kind = torch.device("cuda" if device is None else device).type
        return DeviceMesh(kind, torch.arange(n).reshape(tuple(shape)),
                          mesh_dim_names=tuple(axes))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def flat_view(mesh: DeviceMesh, axes: Tuple[str, ...] = POD_DATA) -> DeviceMesh:
    """``mesh`` with its dimensions ``axes``, next to each other and in
    order, merged into one (`parallel.sharding.merge_dim`) over the same
    ranks (see the module docstring); raises `ValueError` where they are
    not.  It is a new `DeviceMesh` (its own process groups, and its own
    entries in DTensor's caches, which key on the mesh's shape and names)."""
    names = tuple(mesh.mesh_dim_names or ())
    first = names.index(axes[0]) if axes[0] in names else -1
    if first < 0 or names[first:first + len(axes)] != tuple(axes) \
            or mesh_axis_names(mesh) != names:
        raise ValueError(f"mesh axes {tuple(axes)} are not dimensions of their own, "
                         f"next to each other, in {mesh_axis_names(mesh)}")
    shape = tuple(mesh.mesh.shape)
    merged = [(a, n) for a, n, m in mesh_axes(mesh) if a in axes]
    flat_shape = shape[:first] + (math.prod(shape[first:first + len(axes)]),) \
        + shape[first + len(axes):]
    flat_names = names[:first] + (merge_dim(tuple(merged)),) + names[first + len(axes):]
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(flat_shape),
                      mesh_dim_names=flat_names)


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake world of ``size`` ranks, where
    collectives return without moving data, unless a process group is open
    already (which then must have ``size`` ranks or more).  For tracing a
    step over a production mesh on one host; the fake group comes from
    `torch.testing._internal.distributed.fake_pg` (not a public API)."""
    if dist.is_initialized():
        _check_world(size, (size,))
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def mesh_context(mesh: DeviceMesh):
    """Context manager installing ``mesh`` as the current mesh (a
    `DeviceMesh` is its own context manager)."""
    return mesh


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The batch-parallel axes of a mesh ("pod" composes with "data")."""
    names = mesh_axis_names(mesh)
    return tuple(a for a in POD_DATA if a in names) or (names[0],)


def model_axis(mesh: DeviceMesh) -> Optional[str]:
    return "model" if "model" in mesh_axis_names(mesh) else None
