"""Activation-checkpoint (remat) policies for per-layer bodies (port of
`repro/parallel/remat.py`).

Policies (selected per config by ``ModelConfig.remat_policy``):

  "none"  — save everything autograd wants to save (fastest, most memory);
  "dots"  — save only the outputs of products without batch dims
            (weights-stationary checkpointing: the projections) and
            recompute the rest, by selective checkpointing;
  "full"  — save only the layer's inputs and recompute the whole layer in
            the backward (minimum memory).

The reference wraps its `lax.scan` body in `jax.checkpoint`; the port's
stacks call the wrapped body once per layer.  Both checkpointing policies
use `torch.utils.checkpoint.checkpoint` without reentrancy, so a layer's
kernels run twice in a training step: in the forward and in the recompute,
which runs under the forward's `activation_sharding` context.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.parallel.constraints import activation_sharding, current_context

__all__ = ["POLICIES", "remat_wrap"]

POLICIES = ("none", "dots", "full")

_MM = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
_BMM = torch.ops.aten.bmm.default


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """What XLA's `checkpoint_dots_with_no_batch_dims` saves: products without
    a batch dimension.  `torch.einsum` lowers every contraction to `bmm`,
    with a batch extent of 1 where the product has no batch dimension (a
    projection ``btd,df->btf``); attention's and the SSD's products keep
    theirs (B·H, B·C·G) and are recomputed."""
    if op in _MM or (op is _BMM and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _in_context(fn: Callable) -> Callable:
    """``fn`` under the `activation_sharding` context active where this is
    called (the forward), so that a checkpoint's recompute takes the route
    the forward took: on the card it runs in autograd's thread, where the
    forward's thread-local context is not set."""
    ctx = current_context()
    if ctx is None:
        return fn

    def body(*a, **kw):
        with activation_sharding(*ctx):
            return fn(*a, **kw)

    return body


def remat_wrap(fn: Callable, policy: str) -> Callable:
    if policy == "none":
        return fn
    if policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return functools.wraps(fn)(lambda *a, **kw: checkpoint(
            _in_context(fn), *a, use_reentrant=False, context_fn=context_fn, **kw))
    if policy == "full":
        return functools.wraps(fn)(lambda *a, **kw: checkpoint(
            _in_context(fn), *a, use_reentrant=False, **kw))
    raise ValueError(f"unknown remat policy {policy!r}; expected one of {POLICIES}")
