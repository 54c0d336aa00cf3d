"""Parameter and state specification trees (port of `repro/models/spec.py`).

A model describes its parameters once, as a nested dict of `TensorSpec`
(shape, dtype, logical axes, initializer).  The same spec tree is then
materialized three ways:

  * ``init_tree(generator, specs)``  → real tensors on a device;
  * ``abstract_tree(specs)``         → tensors on the ``meta`` device, the
                                       twin of `jax.ShapeDtypeStruct`: shape
                                       and dtype, no allocation;
  * ``partition_tree(specs, rules)`` → a `PartitionSpec` per leaf, each
                                       logical axis mapped through ``rules``
                                       (see `parallel.sharding`).

`count_params` / `tree_bytes` size a tree without allocating anything.

Random initial values differ from the reference's (`jax.random` and
`torch.Generator` draw different numbers from one seed); tests that compare
the packages move the reference's values across (`models.convert`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

__all__ = ["TensorSpec", "abstract_tree", "count_params", "flatten", "init_tree", "is_spec",
           "leaves", "partition_tree", "tree_bytes", "tree_map", "unflatten"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Declarative description of one parameter / state tensor."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    # One logical axis name (or None) per dimension, e.g. ("embed", "ffn").
    axes: Tuple[Optional[str], ...] = ()
    init: str = "zeros"  # zeros | normal | scaled_normal | ones
    init_scale: float = 1.0

    def __post_init__(self) -> None:
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def is_spec(x: Any) -> bool:
    return isinstance(x, TensorSpec)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts, lists and tuples (specs or
    tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple (`OptState`)
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def flatten(tree: Any) -> List[Any]:
    """The leaves of a tree in `tree_map`'s order (dicts in insertion order)."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def unflatten(tree: Any, values: List[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``values`` in `flatten`'s order."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) pairs in the tree's order; dict keys sorted, as
    `jax.tree.leaves` orders them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _init(spec: TensorSpec, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        std = spec.init_scale
    elif spec.init == "scaled_normal":
        # Fan-in scaled (LeCun) init: scale / sqrt(fan_in).
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.init_scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    if spec.dtype == torch.float32 or len(spec.shape) < 2:
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(std).to(spec.dtype)
    # Drawn in float32 a block of the leading axis (up to 2^26 values) at a
    # time, so that a large bfloat16 leaf (a layer's experts) never has a
    # whole float32 twin.
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    rows = max(1, (1 << 26) // math.prod(spec.shape[1:]))
    for i in range(0, spec.shape[0], rows):
        x = torch.randn((min(rows, spec.shape[0] - i),) + spec.shape[1:], generator=generator,
                        dtype=torch.float32, device=device)
        out[i:i + rows] = x.mul_(std)
    return out


def init_tree(generator: torch.Generator, specs: Any, device=None) -> Any:
    """Materialize a spec tree on ``device`` (the generator's by default),
    drawing each leaf in turn from ``generator``."""
    dev = torch.device(device) if device is not None else generator.device
    return tree_map(lambda s: _init(s, generator, dev), specs)


def abstract_tree(specs: Any) -> Any:
    """Stand-ins on the ``meta`` device (shape and dtype, no allocation)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def partition_tree(specs: Any, rules: dict) -> Any:
    """Map logical axes → mesh axes through ``rules`` (None = replicated).

    A rule value may be a mesh-axis name, a tuple of mesh axes, or None.
    Axes missing from ``rules`` are replicated; trailing Nones are trimmed.
    """
    from repro_torch.parallel.sharding import PartitionSpec  # local: avoids an import cycle

    def leaf_pspec(s: TensorSpec) -> PartitionSpec:
        entries = [rules.get(ax) if ax is not None else None for ax in s.axes]
        return PartitionSpec(*entries)

    return tree_map(leaf_pspec, specs)


def count_params(specs: Any) -> int:
    return sum(math.prod(s.shape) for _, s in leaves(specs))


def tree_bytes(specs: Any) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for _, s in leaves(specs))
