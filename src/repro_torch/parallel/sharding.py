"""Logical-axis → mesh-axis sharding rules with divisibility-aware resolution
(port of `repro/parallel/sharding.py`).

Every tensor in the zoo carries *logical* axis names (see models/layers.py).
A ``ShardingRules`` maps those to mesh axes; ``resolve_pspec`` turns one
TensorSpec into a `PartitionSpec`, **dropping any mesh axis that does not
evenly divide the tensor dimension** (whisper's 6 heads or 51865 vocab on a
16-way model axis simply stay replicated — the config remains valid on any
mesh instead of failing).

Rule sets:
  * ``default_rules``      — data parallel over ("pod","data"), tensor
                             parallel over "model", optional FSDP: the
                             "embed" axis of weight matrices sharded over
                             "data" (ZeRO-3).
  * per-config overrides   — arch configs may override single entries
                             (e.g. long-context decode shards "cache_seq").

The mesh is a `torch.distributed.device_mesh.DeviceMesh` (`launch.mesh`);
`mesh_axis_size` reads an axis's extent from its ``mesh_dim_names`` (or its
merged axes, below).
`named_sharding_tree` turns each resolved spec into the DTensor placements
(`Shard` / `Replicate`, one per mesh dimension) that `distribute_tensor`
takes.  A spec entry lists its mesh axes major first, and DTensor shards one
tensor dimension over several mesh dimensions in mesh order: an entry
whose axes run against the mesh's order (the default ``cache_seq`` rule,
("model", "data") on a ("data", "model") mesh, where the batch leaves both
free) has no `Shard` placements, and `placements` raises rather than lay
the shards out in another order.

A mesh may merge adjacent axes into one dimension (`launch.mesh.flat_view`:
("pod", "data") as one dimension of 32 on the multi-pod mesh).  It keeps
its axes' names and sizes (`mesh_axes`), so rules resolve on it as on the
mesh it came from; `placements` maps an entry that names a merged
dimension's axes together, in order, to one `Shard` of that dimension, and
raises for an entry that names only some of them, or names them against
the mesh's order: a step whose specs all lay out there runs over the merged
mesh (`launch.build.traced_mesh`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

__all__ = [
    "PartitionSpec",
    "ShardingRules",
    "default_rules",
    "POD_DATA",
    "merge_dim",
    "mesh_axes",
    "mesh_axis_names",
    "mesh_axis_size",
    "mesh_dims",
    "named_sharding_tree",
    "placements",
    "resolve_pspec",
    "resolve_tree",
]

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec:
    """One entry per tensor dimension: None (replicated), a mesh axis, or a
    tuple of mesh axes (major first), trailing Nones trimmed.  Immutable,
    and a leaf of a tree (not a tuple), as `jax.sharding.PartitionSpec` is;
    iterating it gives the entries."""

    __slots__ = ("_entries",)

    def __init__(self, *entries: MeshAxes):
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        object.__setattr__(self, "_entries", tuple(entries))

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable mapping logical-axis → mesh axis (or tuple of mesh axes)."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    @classmethod
    def from_dict(cls, d: Dict[str, MeshAxes]) -> "ShardingRules":
        return cls(tuple(sorted(d.items(), key=lambda kv: kv[0])))

    def to_dict(self) -> Dict[str, MeshAxes]:
        return dict(self.rules)

    def get(self, axis: Optional[str]) -> MeshAxes:
        if axis is None:
            return None
        return dict(self.rules).get(axis)

    def override(self, **kw: MeshAxes) -> "ShardingRules":
        d = self.to_dict()
        d.update(kw)
        return ShardingRules.from_dict(d)


def default_rules(
    *,
    data_axes: Tuple[str, ...] = ("data",),
    model_axis: str = "model",
    fsdp: bool = True,
) -> ShardingRules:
    """The framework's standard rule set.

    ``data_axes`` is ("pod","data") on the multi-pod mesh so gradient
    reduction composes across pods.  ``fsdp`` shards the "embed" axis of
    weights over the data axes (ZeRO-3).

    KV-cache length ("cache_seq") shards over ("model",)+data_axes: none of
    the zoo's kv-head counts divide a 16-way model axis, so the model axis
    would otherwise idle on decode caches.  Axes already consumed by the
    batch dim are skipped per-tensor by ``resolve_pspec``, which also gives
    long-context (batch=1) cells the full ("model","data") cache sharding.
    """
    batch: MeshAxes = data_axes if len(data_axes) > 1 else data_axes[0]
    fs: MeshAxes = batch if fsdp else None
    cache_entry: MeshAxes = (model_axis,) + tuple(data_axes)
    return ShardingRules.from_dict(
        {
            "batch": batch,
            "embed": fs,
            "heads": model_axis,
            "kv_heads": model_axis,
            "head_dim": None,
            "ffn": model_axis,
            "vocab": model_axis,
            "experts": model_axis,
            "expert_ffn": None,
            "ssm_inner": model_axis,
            "ssm_state": None,
            "layers": None,
            "cache_seq": cache_entry,
            # --- activation-only logical axes (constraints) ---------------
            "seq": None,  # set to model_axis for sequence parallelism
            "act_embed": None,  # residual-stream feature dim stays local
            "capacity": batch,  # MoE slot buffers shard capacity over data
        }
    )


# The multi-pod mesh's batch axes, which a step may trace merged into one
# mesh dimension (`launch.mesh.flat_view`).
POD_DATA = ("pod", "data")

# Merged mesh dimensions by (name, size): their axes, ((name, size), ...),
# major first.  Keyed by the dimension, not by the mesh object, so that a
# mesh DTensor rebuilds from the same names and shape (a sub-mesh, a cached
# copy) reads the same axes.
_MERGED: Dict[Tuple[str, int], Tuple[Tuple[str, int], ...]] = {}


def merge_dim(axes: Tuple[Tuple[str, int], ...]) -> str:
    """Record a mesh dimension merging ``axes`` ((name, size), major first)
    and return its name, the axes' names joined by "_".  Raises
    `ValueError` where the same name and size merge other sizes already."""
    name, axes = "_".join(a for a, _ in axes), tuple(axes)
    key = (name, math.prod(n for _, n in axes))
    if _MERGED.setdefault(key, axes) != axes:
        raise ValueError(f"mesh dimension {key} merges {_MERGED[key]} already, not {axes}")
    return name


def mesh_axes(mesh) -> Tuple[Tuple[str, int, int], ...]:
    """(name, size, mesh dimension) of each axis of ``mesh``, major first:
    its dimensions, or on a dimension that merges axes (`merge_dim`), each
    of them on that dimension."""
    out = []
    for m, a in enumerate(mesh.mesh_dim_names or ()):
        size = int(mesh.size(m))
        out += [(b, n, m) for b, n in _MERGED.get((a, size), ((a, size),))]
    return tuple(out)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The names of ``mesh``'s axes, major first (`mesh_axes`)."""
    return tuple(a for a, _, _ in mesh_axes(mesh))


def mesh_axis_size(mesh, axis: str) -> int:
    """The extent of the mesh axis named ``axis`` (the reference's
    ``mesh.shape[axis]``)."""
    for a, size, _ in mesh_axes(mesh):
        if a == axis:
            return size
    raise KeyError(f"mesh axis {axis!r} not in {mesh_axis_names(mesh)}")


def mesh_dims(mesh, axes: Tuple[str, ...], what: str = "tensor") -> Tuple[int, ...]:
    """The mesh dimensions that one tensor dimension sharded over ``axes``
    (major first) occupies, in order.  Raises `ValueError` when the axes run
    against the mesh's order, or name only some of a merged dimension's
    axes or name them out of order (see the module docstring)."""
    table, names = mesh_axes(mesh), mesh_axis_names(mesh)
    where = {a: (m, i) for i, (a, _, m) in enumerate(table)}
    missing = [a for a in axes if a not in where]
    if missing:
        raise KeyError(f"mesh axes {missing} not in {names}")
    order = [where[a][1] for a in axes]
    dims = sorted({where[a][0] for a in axes})
    whole = [i for i, (_, _, m) in enumerate(table) if m in dims]
    if order != sorted(order):
        raise ValueError(
            f"{what}: shards one dimension over mesh axes {tuple(axes)}, major first, but "
            f"DTensor shards over mesh dimensions in the mesh's order {names}")
    if order != whole:
        raise ValueError(
            f"{what}: shards one dimension over mesh axes {tuple(axes)}, which name part of "
            f"a mesh dimension merging {tuple(names[i] for i in whole)}")
    return tuple(dims)


def resolve_pspec(spec: "TensorSpec", rules: ShardingRules, mesh) -> PartitionSpec:  # noqa: F821
    """PartitionSpec for one TensorSpec, dropping non-dividing mesh axes.

    For tuple entries every usable axis is kept (unavailable or
    non-dividing axes are skipped — ("model","data") degrades to ("data",)
    when the model axis is taken).  Mesh axes already consumed by an earlier
    tensor dimension are never reused (a spec must not repeat axes).
    """
    if not spec.axes:
        return PartitionSpec()
    used: set = set()
    entries: list = []
    for dim, ax in zip(spec.shape, spec.axes):
        entry = rules.get(ax)
        if entry is None:
            entries.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        kept: list = []
        size = 1
        for a in axes:
            asize = mesh_axis_size(mesh, a)
            if a in used or dim % (size * asize) != 0:
                continue
            kept.append(a)
            size *= asize
        if not kept:
            entries.append(None)
        else:
            used.update(kept)
            entries.append(kept[0] if len(kept) == 1 else tuple(kept))
    return PartitionSpec(*entries)


def resolve_tree(specs: Any, rules: ShardingRules, mesh) -> Any:
    """PartitionSpec tree for a TensorSpec tree."""
    from repro_torch.models.spec import tree_map  # local: avoids an import cycle

    return tree_map(lambda s: resolve_pspec(s, rules, mesh), specs)


def placements(pspec: PartitionSpec, mesh, what: str = "tensor") -> Tuple[Any, ...]:
    """The DTensor placements of ``pspec`` over ``mesh``: for each mesh
    dimension, `Shard(d)` when tensor dimension d's entry names it (or, on
    a merged dimension, all its axes), else `Replicate()`.  Raises
    `ValueError` for an entry that `mesh_dims` cannot lay out (see the
    module docstring); ``what`` names the tensor in the message."""
    out: list = [Replicate()] * mesh.ndim
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for m in mesh_dims(mesh, axes, f"{what}: spec {pspec}, dimension {d}"):
            out[m] = Shard(d)
    return tuple(out)


def _map_named(fn, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{path}{k}.") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, v, f"{path}{f}.") for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, f"{path}{i}.") for i, v in enumerate(tree))
    return fn(path[:-1], tree)


def named_sharding_tree(specs: Any, rules: ShardingRules, mesh) -> Any:
    """Placements tree for a TensorSpec tree: each leaf's `placements`
    (what ``distribute_tensor(x, mesh, placements)`` takes)."""
    return _map_named(lambda path, s: placements(resolve_pspec(s, rules, mesh), mesh,
                                                 f"{path} {s.shape} {s.axes}"), specs)
