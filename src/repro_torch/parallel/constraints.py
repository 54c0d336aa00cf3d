"""Activation sharding constraints (port of `repro/parallel/constraints.py`).

The reference pins activations at layer boundaries with
``with_sharding_constraint``; models stay pure by reading the active
(rules, mesh) from a context set by the launcher around tracing.  Here the
context is thread-local state set by `activation_sharding`.

When no context is active (single-device runs) every constraint is the
identity.  Inside one, `shard_activation` resolves the spec (a rank
mismatch raises, as in the reference) and redistributes a `DTensor` to the
resolved placements (`parallel.spmd.redistribute`: on a mesh of CPU
devices, too, a shard moved between tensor dimensions is one all-to-all); a
plain tensor is returned unchanged, since a sharding constraint never
changes values (the expert-parallel MoE and the pipeline, which split work
across ranks, read the context themselves).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import ShardingRules, placements, resolve_pspec
from repro_torch.parallel.spmd import redistribute

__all__ = ["activation_sharding", "shard_activation", "current_context"]

_CTX = threading.local()


def current_context() -> Optional[Tuple[ShardingRules, object]]:
    """The active (rules, mesh), or None."""
    return getattr(_CTX, "value", None)


@contextlib.contextmanager
def activation_sharding(rules: ShardingRules, mesh) -> Iterator[None]:
    prev = current_context()
    _CTX.value = (rules, mesh)
    try:
        yield
    finally:
        _CTX.value = prev


def shard_activation(x: torch.Tensor, axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    """Constrain ``x`` to the sharding its logical ``axes`` resolve to.

    The identity outside an ``activation_sharding`` context, and axes that
    don't divide are dropped by ``resolve_pspec`` — always safe to call.
    """
    ctx = current_context()
    if ctx is None:
        return x
    from repro_torch.models.spec import TensorSpec  # local: avoids an import cycle

    rules, mesh = ctx
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} rank != array rank {x.ndim}")
    ps = resolve_pspec(TensorSpec(tuple(x.shape), x.dtype, tuple(axes)), rules, mesh)
    if isinstance(x, DTensor):
        return redistribute(x, placements(ps, mesh, f"activation {axes}"))
    return x
