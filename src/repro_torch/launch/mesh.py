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
The production meshes need 256 or 512 ranks: the CPU tests build them in
one process over the fake process group of `torch.testing._internal`
(not a public API).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["data_axes", "make_mesh", "make_production_mesh", "mesh_context", "model_axis"]


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` on ``device`` (``None``: the card,
    which becomes the process's current CUDA device)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_context(mesh: DeviceMesh):
    """Context manager installing ``mesh`` as the current mesh (a
    `DeviceMesh` is its own context manager)."""
    return mesh


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The batch-parallel axes of a mesh ("pod" composes with "data")."""
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in ("pod", "data") if a in names) or (names[0],)


def model_axis(mesh: DeviceMesh) -> Optional[str]:
    return "model" if "model" in mesh.mesh_dim_names else None
